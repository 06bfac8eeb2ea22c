"""Oracle for the SSD scan kernel: the exact sequential recurrence
(shared with models.ssm — one source of truth for the math)."""
from ...models.ssm import ssd_chunked as ssd_chunked_ref
from ...models.ssm import ssd_reference

__all__ = ["ssd_reference", "ssd_chunked_ref"]

from .analyze import (HW, CellResult, analyze_step, collective_bytes,
                      roofline_terms)

__all__ = ["HW", "CellResult", "analyze_step", "collective_bytes",
           "roofline_terms"]

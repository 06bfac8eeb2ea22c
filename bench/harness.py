"""One run of one cell: the context a driver works in, the measured
window, and the result line's contents.

A driver (``bench/drivers/<name>.py``) gets a ``Context``, sets up (the
set-up time runs until the window opens), runs the window, and after it
checks what the timed path produced: ``ctx.report`` takes an end-to-end
number, ``ctx.check`` a number compared against the cell's limit, and
``ctx.reading`` a control's or a planted fault's reading of the same
number (calibration only). The harness assembles the metrics that the
cell declares, end-to-end without ``--trace`` and per-layer with it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import spec
from .trace import WINDOW, Recorder, Trace, breakdown, device_profile

# the configuration file's keys (Hugging Face names) -> the port's
# ModelConfig fields: the file states what the system under test runs.
# The port's ``window`` covers every layer, so "sliding_window" is refused
# where the file says the window covers only some (see ``port_fields``).
PORT_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "vocab_size": "vocab", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
    "intermediate_size": "d_ff", "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_eps", "q_lora_rank": "q_lora_rank",
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
    "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
    "n_routed_experts": "n_experts", "num_local_experts": "n_experts",
    "num_experts_per_tok": "top_k", "moe_intermediate_size": "d_ff_expert",
    "sliding_window": "window",
}
# the configuration file's keys that set no ModelConfig field, and why. A
# file may add its own in a "descriptive" map (key -> why), and its own
# key -> field pairs in a "port_fields" map, for fields a later port adds.
DESCRIPTIVE = {
    "arch": "names the port's registered configuration, whose fields the "
            "mapped keys replace",
    "family": "names the plain reference and the operation counts "
              "(bench/reference/<family>.py, bench/flops/<family>.py)",
    "source": "the published configuration the file copies",
    "paper": "the paper that describes the model",
    "model_type": "the published architecture's name; arch and family say "
                  "what runs",
    "hidden_act": "each family's reference and the port run SwiGLU with "
                  "SiLU; another activation is another family",
    "max_position_embeddings": "the published context; the traffic sets "
                               "the lengths run and the cache's size",
    "dtype": "the precision served and trained in: port_config sets "
             "param_dtype and compute_dtype from it",
    "reduced": "each key changed from the source, and why",
    "assumed": "each size the source does not give, and why",
    "deployment": "the deployment the cut configuration stands for",
    "store": "the checkpoint store's settings the deploy driver runs",
    "tie_word_embeddings": "the references run an untied head: a file that "
                           "says true is refused",
    "use_sliding_window": "whether the published window is on: a file "
                          "that says false may not set sliding_window",
    "port_fields": "the file's own key -> ModelConfig field pairs",
    "descriptive": "the file's own keys that set no field, and why",
}
# keys that say a sliding window covers only some layers, and published
# architectures whose window alternates with global layers without one
_WINDOW_PATTERN = ("layer_types", "sliding_window_pattern",
                   "max_window_layers")
_ALTERNATING = ("gemma2", "gemma3", "gemma3_text", "cohere2")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SEED_SPACE = 2 ** 63


def port_fields(conf: dict) -> dict:
    """The ModelConfig fields a configuration file sets: its keys mapped
    by ``PORT_FIELDS`` and by the file's own ``port_fields``, which may
    name only fields that ModelConfig has. Refuses a key that is neither
    applied nor described (by ``DESCRIPTIVE`` or the file's own
    ``descriptive``), since the file would state something the port does
    not run; and a file that states a tied head or a sliding window over
    only some layers, which the port's fields cannot say."""
    from repro_torch.models.config import ModelConfig
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    name = conf.get("arch")
    own = conf.get("port_fields", {})
    lacking = sorted(f for f in own.values() if f not in known)
    if lacking:
        raise ValueError(f"{name}: port_fields names {lacking}, "
                         f"which ModelConfig does not have")
    applied = {**PORT_FIELDS, **own}
    told = conf.get("descriptive", {})
    both = sorted(set(applied) & set(told))
    if both:
        raise ValueError(f"{name}: {both} are applied to ModelConfig and "
                         f"listed as descriptive")
    if not all(isinstance(why, str) and why for why in told.values()):
        raise ValueError(f"{name}: every descriptive key needs its reason")
    unknown = sorted(set(conf) - set(applied) - set(DESCRIPTIVE) - set(told))
    if unknown:
        raise ValueError(
            f"{name}: {unknown} set no ModelConfig field and are not "
            f"described: map each in the file's \"port_fields\" (key -> "
            f"field), or give its reason in the file's \"descriptive\" "
            f"(key -> why)")
    if conf.get("tie_word_embeddings", False) is not False:
        raise ValueError(f"{name}: tie_word_embeddings must be false: the "
                         f"references run an untied head")
    if conf.get("sliding_window") is not None and (
            conf.get("use_sliding_window") is False
            or any(k in conf for k in _WINDOW_PATTERN)
            or conf.get("model_type") in _ALTERNATING):
        raise ValueError(f"{name}: sliding_window covers only some layers "
                         f"here, and the port's window covers every layer")
    return {f: conf[k] for k, f in applied.items() if k in conf}


def port_config(conf: dict):
    """The port's ModelConfig for a configuration file, after checking
    that the benchmark's weight layout is the port's parameter tree."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import param_specs
    cfg = get_config(conf["arch"]).replace(
        param_dtype=conf["dtype"], compute_dtype=conf["dtype"],
        **port_fields(conf))
    ref, _ = spec.family(conf)
    want = {p: (tuple(s), torch.float32 if std is None
                else _DTYPES[conf["dtype"]])
            for p, (s, std) in ref.weight_spec(conf).items()}
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in _flat(param_specs(cfg)).items()}
    if want != got:
        raise ValueError(f"{conf['arch']}: the benchmark's weight layout "
                         f"differs from the port's: {sorted(set(want.items()) ^ set(got.items()))[:4]}")
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(tree[k], p) if isinstance(tree[k], dict)
                   else {p: tree[k]})
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """The measured window: synchronised at both ends; in a traced run the
    profiler runs exactly around it. The device's peak memory is read when
    it closes, before any check runs."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.prof = None
        self._range = None
        self.t0 = self.t1 = None
        self.memory_peak = 0

    def __enter__(self) -> "Window":
        sync(self.ctx.device)
        if self.ctx.traced:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        sync(self.ctx.device)
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
        if torch.device(self.ctx.device).type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def remaining(self) -> float:
        return self.t0 + self.ctx.seconds - time.perf_counter()


class Context:
    def __init__(self, conf: dict, mix: dict, limits: Dict[str, float],
                 seed: int, seconds: float, device, traced: bool,
                 readings: Tuple[str, ...] = ()):
        self.config = conf
        self.mix = mix
        self.limits = limits
        self.seed = seed % SEED_SPACE
        self.seconds = seconds
        self.device = torch.device(device)
        self.traced = traced
        self.family, self.flops = spec.family(conf)
        self.cfg = port_config(conf)
        self.dtype = _DTYPES[conf["dtype"]]
        self.rec = Recorder(traced)
        self.window: Optional[Window] = None
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.modes = readings            # controls or faults to read
        self.readings: Dict[str, Dict[str, float]] = {m: {} for m in readings}
        self.attempted = 0
        self.failed = 0
        self.notes: Dict[str, list] = {}  # printed with the run's facts

    def rng(self, *purpose: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *purpose])

    def weights(self) -> dict:
        """The served weights, made on the device from the seed."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self.family.init_weights(self.config, gen, self.device,
                                        self.dtype)

    def open_window(self) -> Window:
        self.window = Window(self)
        return self.window

    def report(self, name: str, value: float) -> None:
        self.e2e[name] = float(value)

    def check(self, name: str, value: float) -> None:
        self.checks[name] = (float(value), float(self.limits[name]))

    def reading(self, mode: str, name: str, value: float) -> None:
        self.readings[mode][name] = float(value)

    def note(self, name: str, value) -> None:
        self.notes.setdefault(name, []).append(value)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, decl: Optional[dict] = None,
             overrides: Optional[dict] = None,
             readings: Tuple[str, ...] = ()) -> Tuple[dict, Context]:
    """Run a cell once -> (the result line's dict without ``device``'s
    card fields, the context). ``overrides`` replaces keys of the
    configuration, the mix and the limits (small sizes for tests on the
    CPU, with limits of their own)."""
    decl = decl or spec.declaration()
    cell = spec.cell(decl, cell_name)
    conf = spec.config(decl, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if overrides:
        conf = {**conf, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    limits = spec.limits(cell_name)
    if overrides:
        limits = {**limits, **overrides.get("limits", {})}
    ctx = Context(conf, mix, limits, seed, seconds, device, traced,
                  readings)
    spec.driver(mix).run(ctx)
    win = ctx.window
    ctx.setup_s = win.t0 - t_start
    ctx.check_s = time.perf_counter() - win.t1
    metrics: Dict[str, dict] = {}
    out: dict = {}
    if traced:
        prof = None
        if ctx.device.type == "cuda":
            names = {n for n, _, _ in ctx.rec.spans}
            prof = device_profile(win.prof, names)
            out["breakdown"] = breakdown(prof)
        tr = Trace(ctx.rec, win.seconds, prof)
        for m in spec.per_layer(decl, cell_name):
            v = spec.reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["profile"] = prof
    else:
        ctx.e2e["setup_s"] = ctx.setup_s
        for m in spec.end_to_end(decl, cell_name):
            metrics[m["name"]] = {"value": ctx.e2e[m["name"]],
                                  "unit": m["unit"]}
    passed = all(v <= lim for v, lim in ctx.checks.values())
    out.update(correct=bool(passed and ctx.failed == 0 and ctx.checks),
               attempted=ctx.attempted, failed=ctx.failed, metrics=metrics,
               memory_peak_bytes=win.memory_peak,
               checks={k: {"value": v, "limit": lim}
                       for k, (v, lim) in ctx.checks.items()})
    return out, ctx


def failed_checks(checks: dict) -> List[str]:
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]

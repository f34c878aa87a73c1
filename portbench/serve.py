"""One run of a cell: the engine built from the cell's files, warmed, a
closed loop served through ``ServingEngine.submit`` / ``.step`` for the
window, the records the metric readers take, and the check of what was
served.

Times are the host clock.  A token's time is when the ``step()`` that
produced it returns: the engine's drain has synchronised with the device
by then.  TTFT runs from ``submit`` to that moment, and each gap between
two consecutive tokens of one request is an inter-token gap (a request's
first two tokens come from one step, its prefill and its first decode,
so that gap is 0).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import check, families, traffic, weights
from .trace import CLIENT, STEP, ModelProxy, read_profile

#: the profiled slice of a traced run: from this share of the window ...
PROFILE_FROM = 0.4
#: ... for this share of it, at most PROFILE_MAX_S seconds
PROFILE_SHARE = 0.2
PROFILE_MAX_S = 5.0


def port_config(spec: dict):
    """The port's ``ModelConfig`` for a configuration file (its arch id
    with the file's overrides) and the file's sizes; raises where the two
    disagree, so the file says what the port runs."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(spec["port"]["arch"]),
                              **spec["port"]["overrides"])
    dm = weights.dims(spec)
    runs = spec["runs_as"]
    want = dict(n_layers=dm["layers"], d_model=dm["d"], n_heads=dm["heads"],
                n_kv_heads=dm["kv"], head_dim=dm["head_dim"],
                d_ff=dm["d_ff"], vocab_size=dm["vocab"],
                tie_embeddings=dm["tied"], mlp_kind=dm["mlp"],
                norm_kind=dm["norm"], rope_theta=runs["rope_theta"],
                dtype=torch.bfloat16, logits_dtype=torch.bfloat16)
    want.update(families.get(dm["family"]).port_fields(dm, runs))
    bad = {k: (getattr(cfg, k), v) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad:
        raise ValueError(f"{spec['name']}: the port's config differs from "
                         f"the file (port, file): {bad}")
    return cfg, dm


class Loop:
    """The closed loop: one request in flight per client; when one
    finishes, its client submits the next at the end of that step."""

    def __init__(self, engine, stream: traffic.Traffic):
        from repro_torch.serving.engine import Request
        from repro_torch.serving.sampler import SamplingParams
        self._request, self._sampling = Request, SamplingParams
        self.engine, self.stream = engine, stream
        self.submitted: dict[str, float] = {}
        self.tokens: dict[str, int] = {}
        self.last: dict[str, float] = {}
        self.finished_seen = 0
        self.n = 0

    def submit(self, prompt: list, new_tokens: int, rid: str = "") -> None:
        if not rid:
            rid, self.n = f"r{self.n}", self.n + 1
        self.engine.submit(self._request(
            rid, prompt=prompt,
            sampling=self._sampling(max_new_tokens=new_tokens)))
        self.submitted[rid] = time.perf_counter()

    def step(self, out: dict = None, profiled: bool = False) -> None:
        """One engine step; its tokens, first-token times and gaps go into
        ``out`` (dropped when None), and every request it finished is
        followed by its client's next."""
        with record_function(STEP):
            self.engine.step()
        now = time.perf_counter()
        eng = self.engine
        done = eng.finished[self.finished_seen:]
        self.finished_seen = len(eng.finished)
        with record_function(CLIENT):
            for req in list(eng.active.values()) + done:
                rid, n = req.request_id, len(req.output_tokens)
                k = self.tokens.get(rid, 0)
                if n > k and out is not None:
                    out["tokens"] += n - k
                    if k == 0:
                        out["ttft_s"].append((now - self.submitted[rid],
                                              profiled))
                    else:
                        out["itl_s"].append((now - self.last[rid], profiled))
                    out["itl_s"] += [(0.0, profiled)] * (n - k - 1)
                self.tokens[rid], self.last[rid] = n, now
            for req in done:
                if req.request_id != "warm":
                    self.submit(*self.stream.next())


def _activities(cuda: bool) -> list:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def _gateway(engine) -> tuple:
    st = engine.gateway.stats
    return st.h2d_crossings + st.d2h_crossings, st.bridge_time_s


def run_cell(spec: dict, mix: dict, seed: int, seconds: float, *,
             trace: bool, device, t0: float, limits=None, patch=None,
             control: bool = False) -> dict:
    """One run.  Returns the records (``rec``, what the metric readers
    take), ``attempted`` and ``failed``, the peak device memory, and the
    check: ``compared`` {number: {value, limit}} for each number
    ``limits`` (a cell's limits file) gives a limit, and ``correct``
    (None without limits).  ``patch(engine)``, if given, is applied after
    the engine is built (the fault tests); ``control`` also reads the
    float8 reference's gaps."""
    from repro_torch.core.bridge import PROFILES, BridgeModel
    from repro_torch.core.policy import cc_aware_defaults
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    cuda = torch.device(device).type == "cuda"
    cfg, dm = port_config(spec)
    params = weights.make(dm, seed, device)
    model = Model(cfg, params=params, device=device)
    engine = ServingEngine(
        model, max_batch=mix["max_batch"], max_len=mix["max_len"],
        bridge=BridgeModel(PROFILES[mix["bridge_profile"]],
                           cc_on=mix["cc_on"]),
        defaults=cc_aware_defaults(mix["cc_on"],
                                   concurrency=mix["clients"]),
        seed=seed, device=device)
    proxy = None
    if trace:
        proxy = engine.model = ModelProxy(model, engine)
    if patch is not None:
        patch(engine)
    stream = traffic.Traffic(mix, seed, dm["vocab"])
    loop = Loop(engine, stream)
    if trace:
        # the profiler's first start sets up its tracing (seconds): in
        # set-up, not in the window
        with profile(activities=_activities(cuda)):
            torch.ones(1, device=device).add_(1)
            if cuda:
                torch.cuda.synchronize()

    # warm-up: the longest prompt of the run, then every client's first
    # request admitted (their prefills) and one decode step
    initial = stream.initial()
    longest = max([len(p) for p, _ in initial] + [mix["prompt"]["max"]])
    loop.submit(stream.rng.integers(1, dm["vocab"], longest).tolist(), 2,
                rid="warm")
    while engine.active or engine.queue:
        loop.step()
    for prompt, new_tokens in initial:
        loop.submit(prompt, new_tokens)
    loop.step()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives as long as the run: out of the collector's
    # way in the window, as a serving process keeps it after start-up
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t0

    out = dict(tokens=0, ttft_s=[], itl_s=[])
    steps, prof, prof_t = [], None, None
    if proxy is not None:
        proxy.calls.clear()
    g0 = _gateway(engine)
    start = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        loop.step(out, profiled=prof is not None)
        s1 = time.perf_counter()
        steps.append(dict(t0=s0, t1=s1, profiled=prof is not None))
        if trace and prof is None and prof_t is None and (
                s1 - start >= PROFILE_FROM * seconds):
            if cuda:
                torch.cuda.synchronize()
            prof = profile(activities=_activities(cuda))
            prof.__enter__()
            proxy.profiling = True
            prof_t = [time.perf_counter(), None]
        elif prof is not None and (
                s1 - prof_t[0] >= min(PROFILE_MAX_S, PROFILE_SHARE * seconds)
                or s1 - start >= seconds):
            if cuda:
                torch.cuda.synchronize()
            prof_t[1] = time.perf_counter()
            proxy.profiling = False
            prof.__exit__(None, None, None)
            prof_done, prof = prof, None
        if s1 - start >= seconds and prof is None:
            break
    end = time.perf_counter()
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize()
    g1 = _gateway(engine)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    rec = dict(setup_s=setup_s, window_s=end - start, steps=steps,
               dims=dm, gateway=dict(crossings=g1[0] - g0[0],
                                     bridge_s=g1[1] - g0[1]), **out)
    if proxy is not None:
        rec["calls"] = list(proxy.calls)
        if prof_t is not None:
            rec["profile"] = read_profile(prof_done, prof_t[1] - prof_t[0])
            del prof_done
    served = [r for r in engine.finished if r.request_id != "warm"]
    failed = sum(len(r.output_tokens) != r.sampling.max_new_tokens
                 for r in served)
    seqs = [dict(prompt=r.prompt, served=list(r.output_tokens))
            for r in check.sample(served, seed, mix["check_requests"])]

    attempted = loop.n

    # the program's state goes before the reference runs
    engine.close()
    engine.caches = None
    del engine, loop, proxy, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = check.gaps(params, spec, seqs, control=control) if seqs else {}
    compared = {name: {"value": got.get(name), "limit": entry["limit"]}
                for name, entry in (limits or {}).items()
                if entry.get("limit") is not None}
    correct = None
    if limits is not None:
        correct = bool(seqs) and failed == 0 and all(
            c["value"] <= c["limit"] for c in compared.values())
    return dict(rec=rec, attempted=attempted, failed=failed,
                memory_peak_bytes=peak, check=got, compared=compared,
                correct=correct)

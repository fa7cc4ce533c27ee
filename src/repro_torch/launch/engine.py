"""Continuous-batching serving engine: slot scheduler + per-slot decode
(counterpart of ``repro/launch/engine.py``).

The decode batch is a fixed grid of ``slots`` lanes over ONE shared KV
cache, and the scheduler refills a finished lane in place instead of
re-batching, so every decode step has the same shapes.

    admit      — pop a queued request and run ``model.slot_prefill`` (a
                 batch-1 prefill scattered into that slot's row of every
                 cache leaf; neighbouring lanes untouched bit for bit),
                 then sample the request's first token from the prefill
                 logits. Attention families right-pad the prompt to the
                 engine's fixed ``prompt_pad`` (pad K/V is overwritten or
                 causally masked — see DESIGN.md §8); recurrent families
                 (ssm/hybrid) prefill at the TRUE prompt length, since a
                 recurrence integrates every token it is fed and no mask
                 can hide pad tokens.
    decode     — ONE ``model.decode_step`` over all slots with a
                 per-slot POSITION VECTOR: each lane RoPEs, writes its cache
                 column, and attends its own ``[0, pos_b]`` prefix (the
                 per-slot attention-length mask). Parked lanes sit past the
                 cache length — their writes drop and nobody reads them.
    sample     — the AK-primitive sampler (launch/serve.py) under the
                 "sampler" tuning preset, with a PER-REQUEST counter-based
                 key for (seed, rid, token_index) (``serve.request_keys``;
                 the reference's ``fold_in`` chain has no torch twin):
                 sampled tokens depend only on (request, index), never on
                 slot assignment or batch composition, which is what makes
                 the engine's output equal a sequential one-request
                 reference.
    retire     — a lane finishes on EOS or its ``max_new`` budget; stats
                 count ONLY tokens up to and including EOS (the historical
                 ``B * max_new`` accounting overcounted dead-lane garbage).

The host loop is double-buffered: the next device step is dispatched BEFORE
the previous step's tokens are fetched for EOS bookkeeping, so host-side
scheduling (EOS checks, queue admission, stats) overlaps device execution —
CUDA's asynchronous launches keep the device busy while Python catches up. The
price is that a finished lane is detected one step late and decodes one
garbage step before refill — emitted outputs are unaffected (the garbage is
never recorded), utilisation dips by one lane-step. ``overlap=False``
restores strictly synchronous bookkeeping (used by the equivalence tests).

Every step reports a heartbeat + step time into ``runtime.supervisor``
(Supervisor.beat / StragglerMonitor.record) — the serving loop joins the
elasticity layer that so far only train loops fed.

PAGED KV CACHE (``paged=True``). Instead of one contiguous
``cache_len`` row per slot, K/V lives in a shared pool of ``num_pages``
fixed-size pages (``page_size`` — a TuningTable knob owned by the
``page_gather`` primitive) and each lane carries a block table mapping its
logical columns onto pool pages. Memory then tracks ACTUAL sequence
lengths: a lane holds ``ceil((prompt + decoded) / page_size)`` pages, not a
worst-case row — the resident-bytes-per-active-token gap the serving
benchmark gates on. The host-side allocator (launch/paging.py) composes AK
primitives for its hot ops (accumulate+searchsortedfirst free-page search,
bincount occupancy, merge_sort_by_key defrag ordering) and adds
copy-on-write prefix reuse: prompt pages are keyed by their exact token
chain at admission, an exact-chain hit SHARES the resident page (refcount)
instead of recomputing it, and the first decode write into a shared page
forks a private copy. Admission defers while the pool is too full for the
next request's prompt (+1 page of decode headroom) — retirements free
pages incrementally (per request, the moment it finishes), so a waiting
request admits as soon as enough of the pool returns. Under ``__debug__``
every engine step asserts free-list conservation (allocated + free ==
pool, and pool references == engine-held references).

The engine runs on the device its parameters lie on; caches, tokens and
the allocator's AK calls follow them there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.kernels import common as KC
from repro_torch.launch.paging import PageExhausted, PagePool
from repro_torch.models import model as M
from repro_torch.runtime import faults, metrics, telemetry
from repro_torch.runtime.supervisor import (
    NodeLossError,
    StragglerMonitor,
    Supervisor,
)

#: Families the slot scheduler supports (per-slot positions + slot-indexed
#: cache refill), as in the reference; encdec and vlm serve through
#: ``serve.serve_loop``'s fixed-batch loop.
ENGINE_FAMILIES = ("dense", "moe", "ssm", "hybrid")

# -- request status lifecycle (RequestResult.status) -------------------------
# PENDING is the only non-terminal state; every request handed to
# ``Engine.run`` leaves with exactly one terminal status, and a terminal
# request holds zero pool pages (asserted under ``__debug__``).
PENDING = "PENDING"        # queued or decoding (transient)
COMPLETED = "COMPLETED"    # finished normally: EOS or max_new budget
REJECTED = "REJECTED"      # backpressure: bounded queue overflowed
TIMED_OUT = "TIMED_OUT"    # deadline expired (queued or mid-decode)
FAILED = "FAILED"          # unrecoverable: node loss or impossible admission
PREEMPTED = "PREEMPTED"    # evicted more than max_preemptions times
TERMINAL = (COMPLETED, REJECTED, TIMED_OUT, FAILED, PREEMPTED)


def _copy_page(caches, src, dst):
    """COW fork: duplicate page ``src`` into page ``dst`` across all K/V
    leaves (page axis 1; layer axis 0 copied whole), in place."""
    for c in caches["kv"].values():
        c[:, dst] = c[:, src]


def _gather_pages(caches, perm):
    """Defrag move: new page p takes old page perm[p], bit for bit."""
    idx = torch.as_tensor(perm, dtype=torch.long,
                          device=caches["kv"]["k"].device)
    return {"kv": {n: c.index_select(1, idx)
                   for n, c in caches["kv"].items()}}


def _sync(t):
    """Wait for the device work behind ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class Request:
    """One serving request: a prompt, a generation budget, and (optionally)
    a deadline + scripted arrival for the fault-tolerance tier."""

    rid: int
    prompt: np.ndarray          # (len,) int32, 0 < len <= engine prompt_pad
    max_new: int = 32
    deadline: int | None = None  # must finish within this many engine steps
    #                              of submission (else status TIMED_OUT)
    submit_step: int = 0         # engine step at which the request arrives


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: list                 # generated ids, truncated at EOS (incl.)
    admitted_step: int = -1      # engine step at FIRST admission (-1: never)
    finished_step: int = -1
    status: str = PENDING        # terminal member of TERMINAL after run()
    preemptions: int = 0         # times evicted + re-queued for recompute

    @property
    def latency_steps(self) -> int:
        return self.finished_step - self.admitted_step + 1


@dataclasses.dataclass
class EngineStats:
    """EOS-aware accounting: ``tokens`` counts exactly the tokens handed
    back to requests — dead-lane garbage after a sequence's EOS never
    inflates tok/s (the fix for the old ``B * max_new`` overcount).

    Wallclock is split set-up-vs-steady: the FIRST prefill and the FIRST
    decode step carry one-time costs (building and loading the kernel
    libraries, the first cuBLAS calls); they are recorded separately in
    ``compile_prefill_s``/``compile_decode_s`` and ``prefill_s``/
    ``decode_s`` hold only the steady-state repeats.

    Paged-mode memory accounting (``resident_bytes``/``active_tokens``/
    ``occupancy`` sampled once per decode step): ``active_tokens`` counts
    the logical tokens live lanes actually hold, ``resident_bytes`` the
    cache bytes backing them — a contiguous engine's resident bytes are
    constant at ``slots * cache_len`` worth while the paged pool tracks
    real lengths, which is exactly what
    ``resident_bytes_per_active_token`` compares."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    compile_prefill_s: float = 0.0
    compile_decode_s: float = 0.0
    steps: int = 0
    tokens: int = 0
    prefills: int = 0
    slot_util: list = dataclasses.field(default_factory=list)
    # -- paged-cache accounting (empty lists / zeros when not applicable) --
    page_size: int = 0
    num_pages: int = 0
    pages_allocated_total: int = 0   # cumulative allocator grants
    prompt_pages_allocated: int = 0  # fresh prompt pages (misses) only —
    prefix_lookups: int = 0          # vs requests * prompt_pages naive
    prefix_hits: int = 0
    cow_forks: int = 0
    defrags: int = 0
    occupancy: list = dataclasses.field(default_factory=list)
    resident_bytes: list = dataclasses.field(default_factory=list)
    active_tokens: list = dataclasses.field(default_factory=list)
    # -- fault-tolerance accounting ---------------------------------------
    preemptions: int = 0         # evictions into the recompute queue
    resumes: int = 0             # replay-prefills of evicted requests
    rejections: int = 0          # backpressure (queue_cap) rejections
    timeouts: int = 0            # deadline expiries (queued or live)
    failures: int = 0            # FAILED retirements (node loss etc.)
    step_retries: int = 0        # supervised device-step retries this run
    faults_injected: int = 0     # injected faults observed this run
    node_loss: str = ""          # non-empty: run degraded on NodeLossError
    # -- per-request timeline (DESIGN.md §11) ------------------------------
    # rid -> {submit_t, admit_t, first_token_t, last_token_t, finish_t
    #         (perf_counter seconds), submit_step, status, tokens}; keys
    # appear as the request reaches each lifecycle point. queue_depth
    # samples len(queue)+len(resume_q) once per decode step.
    timeline: dict = dataclasses.field(default_factory=dict)
    queue_depth: list = dataclasses.field(default_factory=list)

    # -- derived latency distributions -------------------------------------
    def _deltas(self, a: str, b: str) -> list:
        return [tl[b] - tl[a] for tl in self.timeline.values()
                if a in tl and b in tl]

    @staticmethod
    def _pcts(vals) -> dict:
        if not vals:
            return {}
        return {"p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "mean": float(np.mean(vals)), "n": len(vals)}

    @property
    def queue_wait_s(self) -> dict:
        """submit -> admission wait: {} or {p50, p99, mean, n}."""
        return self._pcts(self._deltas("submit_t", "admit_t"))

    @property
    def ttft_s(self) -> dict:
        """submit -> first sampled token (the serving-tier gate metric)."""
        return self._pcts(self._deltas("submit_t", "first_token_t"))

    @property
    def tbt_s(self) -> dict:
        """Mean time between tokens per request (2+ tokens only)."""
        vals = [
            (tl["last_token_t"] - tl["first_token_t"]) / (tl["tokens"] - 1)
            for tl in self.timeline.values()
            if tl.get("tokens", 0) > 1 and "first_token_t" in tl
            and "last_token_t" in tl
        ]
        return self._pcts(vals)

    @property
    def mean_queue_depth(self) -> float:
        return float(np.mean(self.queue_depth)) if self.queue_depth else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.decode_s, 1e-9)

    @property
    def mean_slot_util(self) -> float:
        return float(np.mean(self.slot_util)) if self.slot_util else 0.0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0

    @property
    def resident_bytes_per_active_token(self) -> float:
        """Mean over decode steps of resident cache bytes per live logical
        token — the paged-vs-contiguous memory-economics number."""
        pairs = [(r, a) for r, a in zip(self.resident_bytes,
                                        self.active_tokens) if a > 0]
        if not pairs:
            return 0.0
        return float(np.mean([r / a for r, a in pairs]))

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)


def _publish_run_metrics(stats: EngineStats) -> None:
    """Fold one finished run's EngineStats into the process metrics
    registry (runtime/metrics.py): counters accumulate across runs,
    histograms observe the per-request latency distributions. Push-model
    (once per run, off the hot path); EngineStats itself stays the
    per-run accessor."""
    c = metrics.counter
    c("ak_engine_steps_total", "decode steps dispatched").inc(stats.steps)
    c("ak_engine_tokens_total", "tokens emitted (EOS-aware)").inc(
        stats.tokens)
    c("ak_engine_prefills_total", "prefill dispatches").inc(stats.prefills)
    c("ak_engine_preemptions_total",
      "evictions into the recompute queue").inc(stats.preemptions)
    c("ak_engine_resumes_total",
      "replay-prefills of evicted requests").inc(stats.resumes)
    c("ak_engine_defrags_total", "pool compactions").inc(stats.defrags)
    c("ak_engine_cow_forks_total", "copy-on-write page forks").inc(
        stats.cow_forks)
    if stats.node_loss:
        c("ak_engine_node_loss_total", "runs degraded on NodeLossError").inc()
    statuses = [tl.get("status") for tl in stats.timeline.values()]
    for status in sorted(s for s in statuses if s):
        c("ak_engine_requests_total",
          "requests by terminal status").inc(status=status)
    for name, help_, vals in (
        ("ak_engine_ttft_seconds", "submit -> first token",
         stats._deltas("submit_t", "first_token_t")),
        ("ak_engine_queue_wait_seconds", "submit -> admission",
         stats._deltas("submit_t", "admit_t")),
    ):
        h = metrics.histogram(name, help_)
        for v in vals:
            h.observe(v)
    qd = metrics.histogram("ak_engine_queue_depth",
                           "queued requests sampled per decode step",
                           buckets=(0, 1, 2, 4, 8, 16, 32, 64))
    for d in stats.queue_depth:
        qd.observe(d)


class Engine:
    """Slot scheduler over a shared static-shape decode cache."""

    def __init__(self, params, cfg, *, slots: int = 4, cache_len: int = 64,
                 prompt_pad: int = 16, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 eos_id: int | None = None, fused_sampler: bool = True,
                 overlap: bool = True, ak_tuning: dict | None = None,
                 paged: bool = False, page_size: int | None = None,
                 num_pages: int | None = None, defrag_every: int = 0,
                 monitor: StragglerMonitor | None = None,
                 supervisor: Supervisor | None = None,
                 preempt: bool = False, max_preemptions: int = 8,
                 queue_cap: int | None = None,
                 preempt_script: dict | None = None, host: int = 0):
        if cfg.family not in ENGINE_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} not engine-schedulable (supported: "
                f"{ENGINE_FAMILIES}); use launch.serve.serve_loop"
            )
        if prompt_pad > cache_len:
            raise ValueError("prompt_pad must fit the cache")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["embed"].device
        self.seed = seed
        self.slots = slots
        self.cache_len = cache_len
        self.prompt_pad = prompt_pad
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.fused_sampler = fused_sampler
        self.overlap = overlap
        self.ak_tuning = ak_tuning
        self.monitor = monitor if monitor is not None else StragglerMonitor(1)
        # every decode/prefill dispatch routes through Supervisor.run_step
        # (transient step failures retry with backoff instead of aborting
        # the whole batch); a caller-supplied supervisor brings its own
        # retry budget / sleep / clock for testing
        self.supervisor = (
            supervisor if supervisor is not None
            else Supervisor(None, n_hosts=1)
        )
        self.host = host
        # -- failure-handling policy --------------------------------------
        # preempt=True turns pool exhaustion from a crash into an eviction:
        # the least-progress lane releases its pages and re-enqueues to
        # replay prompt + generated-so-far through the prefill path —
        # per-request rng (fold_in(seed, rid, idx)) makes the resumed
        # continuation token-identical, so preemption is invisible in the
        # output stream.
        self.preempt = preempt
        self.max_preemptions = max_preemptions
        self.queue_cap = queue_cap
        self.preempt_script = preempt_script  # {engine step: rid(s)} —
        #                                       deterministic evictions for
        #                                       tests and the chaos gate
        self.pool: PagePool | None = None     # last run's pool (gates
        #                                       assert conservation on it)

        # recurrent state integrates every fed token — pad tokens would
        # corrupt it (unlike KV caches, where pad columns are overwritten
        # or causally masked), so ssm/hybrid prefill at true length
        self._pad_prompts = cfg.family in M.ATTENTION_FAMILIES

        # bytes one logical cache token costs (K + V across layers) — the
        # memory-economics metric; attention-KV families only
        self._token_bytes = (
            cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
            * torch.empty((), dtype=cfg.dtype).element_size()
            if self._pad_prompts else 0
        )

        self.paged = paged
        self.defrag_every = defrag_every
        if paged:
            if not self._pad_prompts:
                raise ValueError(
                    f"paged KV cache needs an attention-family cache; "
                    f"{cfg.family!r} carries recurrent state"
                )
            if page_size is None:
                # the knob lives with the page_gather primitive so the
                # engine, the tune sweep and the kernel agree on geometry
                page_size = registry.tuning.lookup("page_gather")["page_size"]
            self.page_size = int(page_size or 8)
            if cache_len % self.page_size:
                # equal attention widths (T * page_size == cache_len) keep
                # the paged math BITWISE equal to the contiguous engine —
                # masked-out tail columns contribute exact zeros either
                # way, but a wider reduction regroups the non-zero partials
                raise ValueError(
                    f"cache_len ({cache_len}) must be a multiple of "
                    f"page_size ({self.page_size})"
                )
            self.table_len = cache_len // self.page_size
            self.num_pages = (
                int(num_pages) if num_pages is not None
                else slots * self.table_len
            )
        else:
            self.page_size = self.num_pages = self.table_len = 0

    # -- sampling ----------------------------------------------------------
    def _scope(self):
        return (
            registry.tuning.preset("sampler") if self.ak_tuning is None
            else registry.tuning.overrides(self.ak_tuning)
        )

    def _keys(self, rids, idxs):
        from repro_torch.launch import serve  # lazy: serve imports this

        return serve.request_keys(self.seed, rids, idxs, self.device)

    def _sample(self, keys, logits):
        from repro_torch.launch import serve  # lazy: serve imports this

        with self._scope():
            return serve.sample_logits(
                keys, logits, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, vocab=self.cfg.vocab,
                fused=self.fused_sampler,
            )

    # -- the slot-scheduled loop ------------------------------------------
    def run(self, requests) -> tuple[dict, EngineStats]:
        """Serve ``requests`` (any count >= 0, any order); returns
        ({rid: RequestResult}, EngineStats). Every request completes even
        with more requests than slots — finished slots refill from the
        queue in admission order, live neighbours undisturbed."""
        cfg, B = self.cfg, self.slots
        # scripted arrivals: requests enter the queue when the step clock
        # reaches their submit_step (default 0 = all up front, the
        # historical behaviour); sort is stable so same-step requests keep
        # caller order
        arrivals = deque(sorted(
            (Request(r.rid, np.asarray(r.prompt, np.int32), r.max_new,
                     deadline=r.deadline, submit_step=r.submit_step)
             for r in requests),
            key=lambda r: r.submit_step,
        ))
        queue: deque = deque()
        # evicted requests carrying their replay (generated-so-far) —
        # exempt from queue_cap (they were already accepted) and admitted
        # ahead of fresh requests so preempted work finishes first
        resume_q: deque = deque()
        req_by_rid: dict[int, Request] = {}
        script = dict(self.preempt_script or {})
        results: dict[int, RequestResult] = {}
        stats = EngineStats()
        rt0 = self.supervisor.retries_total
        plan = faults.current()
        f0 = plan.injected if plan is not None else 0

        dev = self.device
        if self.paged:
            caches = M.zero_paged_caches(
                cfg, num_pages=self.num_pages, page_size=self.page_size,
                device=dev,
            )
            pool = PagePool(self.num_pages, self.page_size, device=dev)
            # host block tables; num_pages = the unbacked sentinel (the
            # device copy clamps it to a valid — masked — page id)
            bt = np.full((B, self.table_len), self.num_pages, np.int32)
            held: dict[int, list[int]] = {}   # rid -> pages it references
            stats.page_size = self.page_size
            stats.num_pages = self.num_pages
        else:
            caches = M.zero_caches(cfg, batch=B, cache_len=self.cache_len,
                                   device=dev)
            pool = None
            bt = held = None
        self.pool = pool
        cur_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        pos = np.full((B,), self.cache_len, np.int32)   # parked lanes
        slot_rid: list = [None] * B                     # host slot map
        budget: dict[int, int] = {}                     # rid -> max tokens
        emitted: dict[int, int] = {}                    # rid -> bookkept
        next_idx: dict[int, int] = {}                   # rid -> next sample
        retired: dict[int, bool] = {}
        # double buffer: (tokens_dev, slot-map snapshot, step no) whose
        # host bookkeeping is deferred past the next dispatch
        pending: deque = deque()
        depth = 1 if self.overlap else 0
        ps = self.page_size

        def retire_check(rid, tok):
            return (self.eos_id is not None and tok == self.eos_id) or (
                emitted[rid] >= budget[rid]
            )

        def finish(rid, status, step_no):
            """Terminal transition for an ADMITTED request."""
            retired[rid] = True
            results[rid].status = status
            results[rid].finished_step = step_no
            if status == TIMED_OUT:
                stats.timeouts += 1
            elif status == FAILED:
                stats.failures += 1
            tl = stats.timeline.setdefault(rid, {})
            tl["finish_t"] = time.perf_counter()
            tl["status"] = status
            tl["tokens"] = len(results[rid].tokens)
            if status != COMPLETED:
                telemetry.instant("engine." + status.lower(), cat="engine",
                                  severity="warning", rid=rid, step=step_no)
            if "submit_t" in tl:
                telemetry.async_end("req", rid, status=status)

        def terminal_unadmitted(req, status):
            """Terminal transition for a request that never (re)entered a
            slot — rejected, expired in the queue, or failed on node
            loss. A preempted request keeps its partial tokens."""
            res = results.get(req.rid)
            if res is None:
                res = results[req.rid] = RequestResult(rid=req.rid,
                                                       tokens=[])
            res.status = status
            res.finished_step = stats.steps
            retired[req.rid] = True
            if status == REJECTED:
                stats.rejections += 1
            elif status == TIMED_OUT:
                stats.timeouts += 1
            elif status == FAILED:
                stats.failures += 1
            tl = stats.timeline.setdefault(req.rid, {})
            tl["finish_t"] = time.perf_counter()
            tl["status"] = status
            tl["tokens"] = len(res.tokens)
            telemetry.instant("engine." + status.lower(), cat="engine",
                              severity="warning", rid=req.rid,
                              step=stats.steps)
            if "submit_t" in tl:
                telemetry.async_end("req", req.rid, status=status)

        def supervised(site, fn, *a, **kw):
            """Dispatch a device step through the Supervisor with the
            fault-injection site checked BEFORE the step — no cache is
            written yet when an injected fault fires, so a retry replays
            the step exactly."""
            def step():
                faults.check(site)
                return fn(*a, **kw)
            with telemetry.span(site, cat="engine", step=stats.steps):
                return self.supervisor.run_step(step_fn=step,
                                                host=self.host)

        def admit(slot, req, replay=None) -> bool:
            """Prefill ``req`` into ``slot``; with ``replay`` (the tokens
            a preempted request generated before eviction) the chain
            prompt + replay[:-1] prefills and decoding resumes at token
            index len(replay) — per-request rng makes the continuation
            token-identical to the uninterrupted run. Returns True if the
            slot is live afterwards (False: the request retired on its
            very first token). On failure NOTHING stays acquired: pages
            shared/allocated before the fault are released (the prefix
            index unwinds with them)."""
            nonlocal caches, cur_tok
            faults.check("engine.admit")
            plen = int(req.prompt.shape[0])
            if not 0 < plen <= self.prompt_pad:
                raise ValueError(
                    f"request {req.rid}: prompt len {plen} not in "
                    f"(0, {self.prompt_pad}]"
                )
            rid = req.rid
            # the token chain the cache must hold BEFORE the next decode:
            # the prompt, plus (resuming) everything generated except the
            # last token — that one is the next decode step's input
            chain = (req.prompt if replay is None else
                     np.concatenate([req.prompt,
                                     np.asarray(replay[:-1], np.int32)]))
            clen = int(chain.shape[0])
            t0 = time.perf_counter()
            if self._pad_prompts:
                # fresh prompts pad to prompt_pad (pad K/V is overwritten
                # or causally masked); resumed chains can exceed it —
                # those pad to cache_len
                pad_to = (self.prompt_pad if replay is None
                          else self.cache_len)
                tok_in = np.zeros((1, pad_to), np.int32)
                tok_in[0, :clen] = chain
            else:
                tok_in = chain[None, :]
            tok_dev = torch.from_numpy(tok_in).to(dev)
            if self.paged:
                # chain pages: exact-token-chain lookup first (a hit
                # SHARES the resident page — its K/V is determined by the
                # chain under causal masking + absolute RoPE), allocate
                # only misses; page_vec keeps a static length per trace
                # with the don't-write sentinel in shared and beyond-chain
                # slots.
                n_pp = KC.ceil_div(clen, ps)
                page_vec = np.full((KC.ceil_div(tok_in.shape[1], ps),),
                                   self.num_pages, np.int32)
                row = np.full((self.table_len,), self.num_pages, np.int32)
                acquired: list[int] = []
                try:
                    for i in range(n_pp):
                        end = min((i + 1) * ps, clen)
                        key = tuple(int(t) for t in chain[:end])
                        stats.prefix_lookups += 1
                        hit = pool.lookup(key)
                        if hit is not None:
                            pool.share(hit)
                            stats.prefix_hits += 1
                            row[i] = hit
                        else:
                            pg = pool.alloc(1)[0]
                            pool.register_key(pg, key)
                            row[i] = pg
                            page_vec[i] = pg
                            stats.prompt_pages_allocated += 1
                        acquired.append(int(row[i]))
                    logits, caches = supervised(
                        "engine.prefill", M.paged_prefill,
                        self.params, cfg, tok_dev, caches,
                        torch.from_numpy(page_vec).to(dev),
                        cache_len=self.cache_len, page_size=ps)
                except BaseException:
                    # leak-free unwinding: a partial admission (prefix
                    # pages shared, tail alloc or the prefill itself
                    # failed) hands every acquired reference back
                    for pg in acquired:
                        pool.release(pg)
                    raise
                bt[slot] = row
                held[rid] = acquired
                stats.pages_allocated_total = pool.allocs_total
            else:
                logits, caches = supervised(
                    "engine.prefill", M.slot_prefill,
                    self.params, cfg, tok_dev, caches, slot,
                    cache_len=self.cache_len)
            stats.prefills += 1
            if replay is None:
                key0 = self._keys([rid], [0])
                tok0 = self._sample(key0, logits[:, plen - 1])
                # token i >= 1 is decoded with input token i-1 written at
                # cache column plen + i - 1; the last input stays in-cache
                budget[rid] = min(req.max_new, self.cache_len + 1 - plen)
                emitted[rid] = 0
                next_idx[rid] = 1
                retired[rid] = False
                results[rid] = RequestResult(rid=rid, tokens=[],
                                             admitted_step=stats.steps)
                tl = stats.timeline.setdefault(rid, {})
                tl.setdefault("admit_t", t0)
                t = int(tok0[0])        # sync — prefill is per-request
                dt = time.perf_counter() - t0
                if stats.prefills == 1:
                    stats.compile_prefill_s = dt  # trace+compile heavy
                else:
                    stats.prefill_s += dt
                results[rid].tokens.append(t)
                now = time.perf_counter()
                tl.setdefault("first_token_t", now)
                tl["last_token_t"] = now
                emitted[rid] = 1
                stats.tokens += 1
                if retire_check(rid, t):
                    finish(rid, COMPLETED, stats.steps)
                    if self.paged:  # retired on its first token: give the
                        for pg in held.pop(rid, []):  # pages straight back
                            pool.release(pg)
                        bt[slot] = self.num_pages
                    return False
                cur_tok = cur_tok.clone()  # a deferred step may hold it
                cur_tok[slot, 0] = t
                pos[slot] = plen
            else:
                # resume: no sampling — the next decode step consumes the
                # last generated token at column clen (= plen + k - 1) and
                # samples token index k, exactly where the eviction cut in
                k = len(replay)
                _sync(logits)
                dt = time.perf_counter() - t0
                if stats.prefills == 1:
                    stats.compile_prefill_s = dt
                else:
                    stats.prefill_s += dt
                emitted[rid] = k
                next_idx[rid] = k
                retired[rid] = False
                stats.resumes += 1
                cur_tok = cur_tok.clone()
                cur_tok[slot, 0] = int(replay[-1])
                pos[slot] = clen
            slot_rid[slot] = rid
            return True

        def can_admit(req, replay=None) -> bool:
            """Paged admission gate: defer while the pool cannot cover the
            request's chain pages (all assumed fresh — prefix hits only
            help) plus one page of decode headroom. Deferred requests wait
            for retirements to release pages back."""
            if not self.paged:
                return True
            clen = int(req.prompt.shape[0]) + (
                len(replay) - 1 if replay else 0)
            need = KC.ceil_div(clen, ps) + 1
            return pool.free_count() >= need

        def admit_free_slots() -> bool:
            """Fill free slots: resumes first (they were already accepted
            and carry finished work), then fresh requests in arrival
            order. Returns True iff a transient/injected admission fault
            stopped progress — the request stays at the head of its queue
            for the next attempt."""
            for b in range(B):
                while slot_rid[b] is None and (resume_q or queue):
                    if resume_q:
                        req, replay = resume_q[0]
                        src = resume_q
                    else:
                        req, replay = queue[0], None
                        src = queue
                    if not can_admit(req, replay):
                        return False
                    try:
                        with telemetry.span("engine.admit", cat="engine",
                                            rid=req.rid,
                                            resume=replay is not None,
                                            step=stats.steps):
                            ok = admit(b, req, replay)
                    except (faults.InjectedFault, PageExhausted):
                        # transient: nothing stayed acquired (admit
                        # unwound); same request retries next pass
                        return True
                    src.popleft()
                    if ok:
                        break  # slot is live; next free slot
            return False

        def bookkeep(toks_host, snapshot, step_no):
            """Record one fetched step; returns freed slot indices."""
            freed = []
            now = time.perf_counter()
            for b in range(B):
                rid = snapshot[b]
                if rid is None or retired.get(rid, True):
                    continue
                tok = int(toks_host[b])
                results[rid].tokens.append(tok)
                tl = stats.timeline.get(rid)
                if tl is not None:
                    tl["last_token_t"] = now
                emitted[rid] += 1
                stats.tokens += 1
                if retire_check(rid, tok):
                    finish(rid, COMPLETED, step_no)
                    freed.append(b)
            return freed

        def do_defrag():
            """Compact the pool: AK-sorted permutation (allocated pages
            first, ids ascending — stable for resident data), one device
            gather moves the bytes bit for bit, then host refcounts /
            prefix index / block tables relabel through the inverse."""
            nonlocal caches
            with telemetry.span("engine.defrag", cat="alloc",
                                step=stats.steps):
                perm = pool.defrag_order()
                if np.array_equal(perm, np.arange(self.num_pages)):
                    return
                caches = _gather_pages(caches, perm)
                inv = pool.apply_perm(perm)
                backed = bt < self.num_pages
                bt[backed] = inv[bt[backed]]
                for rid_h, pgs in held.items():  # the rid->pages references
                    held[rid_h] = [int(inv[p]) for p in pgs]
                stats.defrags += 1

        retires_since_defrag = 0

        def drain(keep=0):
            """Fetch + bookkeep deferred steps down to ``keep`` entries.
            Eviction call sites drain to 0 first so a victim's replay
            (tokens + emitted counts) is current when it re-queues."""
            nonlocal retires_since_defrag
            while len(pending) > keep:
                t0 = time.perf_counter()
                toks_dev, snapshot, step_no = pending.popleft()
                with telemetry.span("engine.retire", cat="engine",
                                    step=step_no):
                    freed = bookkeep(toks_dev.cpu().numpy(), snapshot,
                                     step_no)
                    for b in freed:
                        rid_f = snapshot[b]
                        slot_rid[b] = None
                        pos[b] = self.cache_len
                        if self.paged:
                            # incremental release: the pages go back the
                            # moment THIS request retires, not when the
                            # slot is eventually refilled
                            for pg in held.pop(rid_f, []):
                                pool.release(pg)
                            bt[b] = self.num_pages
                    if self.paged and self.defrag_every and freed:
                        retires_since_defrag += len(freed)
                        if retires_since_defrag >= self.defrag_every:
                            do_defrag()
                            retires_since_defrag = 0
                self.monitor.record(0, time.perf_counter() - t0)
                self.supervisor.beat(self.host)

        def evict(b, status=None):
            """Release lane ``b``'s slot + pages. ``status=None`` is a
            PREEMPTION: the request re-queues with its generated-so-far
            replay (or retires PREEMPTED past max_preemptions); any other
            status is terminal (TIMED_OUT/FAILED, partial tokens kept).
            Callers drain(0) first — the replay must include every token
            the device already produced."""
            rid = slot_rid[b]
            res = results[rid]
            slot_rid[b] = None
            pos[b] = self.cache_len
            retired[rid] = True      # re-admission flips it back
            if self.paged:
                for pg in held.pop(rid, []):
                    pool.release(pg)
                bt[b] = self.num_pages
            if status is not None:
                finish(rid, status, stats.steps)
                return
            res.preemptions += 1
            stats.preemptions += 1
            telemetry.instant("engine.preempt", cat="engine",
                              severity="warning", rid=rid,
                              step=stats.steps,
                              tokens_to_replay=len(res.tokens))
            if res.preemptions > self.max_preemptions:
                finish(rid, PREEMPTED, stats.steps)
            else:
                resume_q.append((req_by_rid[rid], list(res.tokens)))

        def victim():
            """Preemption policy: least progress first — fewest emitted
            tokens (least work to replay), youngest admission breaking
            ties (older requests are closer to their deadlines)."""
            cands = [b for b in range(B)
                     if slot_rid[b] is not None
                     and not retired[slot_rid[b]]]
            if not cands:
                return None
            return min(cands, key=lambda b: (
                emitted[slot_rid[b]],
                -results[slot_rid[b]].admitted_step,
                -slot_rid[b],
            ))

        def reclaim_for(b) -> bool:
            """Free at least one page so lane ``b`` can grow: drain first
            (a deferred retirement may already have released enough), then
            preempt least-progress victims — possibly ``b`` itself.
            Returns True iff ``b`` is still live AND a page is free."""
            drain(0)
            while (slot_rid[b] is not None and not retired[slot_rid[b]]
                   and pool.free_count() < 1):
                v = victim()
                if v is None:
                    return False
                evict(v)
            return (slot_rid[b] is not None
                    and not retired[slot_rid[b]]
                    and pool.free_count() >= 1)

        def deadline_expired(req) -> bool:
            return (req.deadline is not None
                    and stats.steps - req.submit_step >= req.deadline)

        def ingest():
            """Move due arrivals into the queue, then enforce the
            backpressure bound: newest requests reject first (they have
            the least chance of meeting any deadline) with a structured
            REJECTED status instead of an exception."""
            while arrivals and arrivals[0].submit_step <= stats.steps:
                req = arrivals.popleft()
                req_by_rid[req.rid] = req
                stats.timeline[req.rid] = {
                    "submit_t": time.perf_counter(),
                    "submit_step": stats.steps,
                }
                telemetry.async_begin(
                    "req", req.rid, rid=req.rid,
                    prompt_len=int(req.prompt.shape[0]),
                    max_new=req.max_new)
                queue.append(req)
            if self.queue_cap is not None:
                while len(queue) > self.queue_cap:
                    terminal_unadmitted(queue.pop(), REJECTED)

        def expire():
            """Deadline sweep: queued requests expire in place; live
            lanes drain + evict with TIMED_OUT (partial tokens kept);
            preempted requests waiting to resume expire out of
            resume_q."""
            for q, unpack in ((queue, lambda e: e),
                              (resume_q, lambda e: e[0])):
                stale = [e for e in q if deadline_expired(unpack(e))]
                for e in stale:
                    q.remove(e)
                    terminal_unadmitted(unpack(e), TIMED_OUT)
            late = [b for b in range(B)
                    if slot_rid[b] is not None
                    and not retired[slot_rid[b]]
                    and deadline_expired(req_by_rid[slot_rid[b]])]
            if late:
                drain(0)
                for b in late:
                    if (slot_rid[b] is not None
                            and not retired[slot_rid[b]]):
                        evict(b, TIMED_OUT)

        def alive():
            return [b for b in range(B) if slot_rid[b] is not None
                    and not retired[slot_rid[b]]]

        t_run = time.perf_counter()
        try:
            while True:
                ingest()
                expire()
                live = alive()
                if not live and not pending:
                    if resume_q or queue:
                        # every admitted request insta-retired, or the
                        # head is waiting on pool pages / faulting
                        qlen = len(queue) + len(resume_q)
                        admit_faulted = admit_free_slots()
                        if (len(queue) + len(resume_q) == qlen
                                and all(r is None for r in slot_rid)):
                            if admit_faulted:
                                continue   # transient; plans are finite
                            if resume_q:
                                head, replay = resume_q[0]
                            else:
                                head, replay = queue[0], None
                            need = (KC.ceil_div(
                                len(head.prompt)
                                + (len(replay) - 1 if replay else 0),
                                ps) + 1) if self.paged else 0
                            if self.preempt:
                                # structurally impossible admission:
                                # retire the head with a status instead
                                # of crashing the whole server
                                (resume_q if replay is not None
                                 else queue).popleft()
                                terminal_unadmitted(head, FAILED)
                                continue
                            raise RuntimeError(
                                f"page pool too small: request "
                                f"{head.rid} needs {need} pages, "
                                f"{pool.free_count()}/{self.num_pages} "
                                f"free with nothing left to retire"
                            )
                        continue
                    if arrivals:
                        # idle until the next scripted arrival: nothing
                        # to decode, so fast-forward the step clock
                        stats.steps = max(stats.steps,
                                          arrivals[0].submit_step)
                        continue
                    break

                if live and script:
                    # scripted (deterministic) preemptions — the chaos
                    # gate and the resume-determinism tests drive the
                    # eviction path at exact step offsets
                    hits = script.pop(stats.steps, None)
                    if hits is not None:
                        for rv in (hits if isinstance(hits, (list, tuple))
                                   else [hits]):
                            b = next((i for i in range(B)
                                      if slot_rid[i] == rv
                                      and not retired.get(rv, True)),
                                     None)
                            if b is not None:
                                drain(0)
                                # the drain may just have retired it
                                if slot_rid[b] == rv and not retired[rv]:
                                    evict(b)
                        live = alive()

                if live and self.paged:
                    # back the column each live lane writes THIS step:
                    # grow into an unbacked table slot, or fork a shared
                    # page (copy-on-write) so co-owners never see the
                    # write; under preemption, exhaustion evicts the
                    # least-progress lane instead of raising
                    for b in list(live):
                        if (slot_rid[b] is None
                                or retired.get(slot_rid[b], True)):
                            continue   # evicted/retired by a reclaim
                        p_next = int(pos[b])
                        if p_next >= self.cache_len:
                            continue
                        si = p_next // ps
                        while True:
                            rid_b = slot_rid[b]
                            cur_pg = int(bt[b, si])
                            try:
                                if cur_pg >= self.num_pages:
                                    pg = pool.alloc(1)[0]
                                    bt[b, si] = pg
                                    held[rid_b].append(pg)
                                elif pool.refcount[cur_pg] > 1:
                                    pg = pool.fork(cur_pg)
                                    _copy_page(caches, cur_pg, pg)
                                    hr = held[rid_b]
                                    hr[hr.index(cur_pg)] = pg
                                    bt[b, si] = pg
                                    stats.cow_forks += 1
                                break
                            except (PageExhausted,
                                    faults.InjectedFault):
                                if not self.preempt:
                                    raise
                                if not reclaim_for(b):
                                    break   # b itself was preempted
                    stats.pages_allocated_total = pool.allocs_total
                    live = alive()

                if not live:
                    # evictions/retirements emptied the decode batch:
                    # settle the books and refill before dispatching
                    drain(0)
                    admit_free_slots()
                    continue

                snapshot = list(slot_rid)
                step_no = stats.steps
                first_step = stats.compile_decode_s == 0.0
                t_step = time.perf_counter()
                if self.paged:
                    # device tables clamp the unbacked sentinel to a
                    # valid page id: reads of it are hidden by the
                    # per-lane attention-length mask, writes never
                    # target it
                    bt_dev = torch.from_numpy(
                        np.minimum(bt, self.num_pages - 1)).to(dev)
                    logits, caches = supervised(
                        "engine.decode", M.decode_step,
                        self.params, cfg, cur_tok, caches,
                        torch.from_numpy(pos.copy()).to(dev),
                        block_tables=bt_dev, page_size=ps)
                else:
                    logits, caches = supervised(
                        "engine.decode", M.decode_step,
                        self.params, cfg, cur_tok, caches,
                        torch.from_numpy(pos.copy()).to(dev))
                rids = [-1 if r is None else r for r in slot_rid]
                idxs = [0 if r is None else next_idx[r] for r in slot_rid]
                with telemetry.span("engine.sample", cat="engine",
                                    step=step_no):
                    keys = self._keys(rids, idxs)
                    tok = self._sample(keys, logits[:, 0])
                cur_tok = tok[:, None]
                if first_step:
                    # the first decode step carries one-time set-up
                    # (kernel libraries, cuBLAS handles): record it apart
                    # so decode_s is steady-state only
                    _sync(cur_tok)
                    stats.compile_decode_s = time.perf_counter() - t_step
                for b in live:
                    rid = slot_rid[b]
                    next_idx[rid] += 1
                    pos[b] = min(pos[b] + 1, self.cache_len)
                stats.steps += 1
                stats.slot_util.append(len(live) / B)
                stats.queue_depth.append(len(queue) + len(resume_q))
                if self._token_bytes:
                    # memory economics, sampled per step: logical tokens
                    # live lanes hold vs the cache bytes backing them
                    active = sum(int(pos[b]) for b in live)
                    if self.paged:
                        resident = (pool.allocated_count() * ps
                                    * self._token_bytes)
                        stats.occupancy.append(pool.occupancy()[0])
                    else:
                        resident = B * self.cache_len * self._token_bytes
                    stats.resident_bytes.append(resident)
                    stats.active_tokens.append(active)
                pending.append((tok, snapshot, step_no))

                # drain deferred bookkeeping (fully once no lane is live)
                drain(depth if alive() else 0)
                admit_free_slots()
                if __debug__ and self.paged:
                    pool.assert_conservation(
                        held_refs=sum(len(v) for v in held.values())
                    )
        except NodeLossError as e:
            # permanent device-step loss: degrade STRUCTURALLY — every
            # request leaves with a terminal status, every page returns
            # to the pool, and the caller gets results, not a traceback
            telemetry.instant("engine.node-loss", cat="engine",
                              severity="error", step=stats.steps,
                              plan=str(e.plan))
            drain(0)
            for b in range(B):
                if slot_rid[b] is not None and not retired[slot_rid[b]]:
                    evict(b, FAILED)
            for req, _replay in list(resume_q):
                terminal_unadmitted(req, FAILED)
            for req in list(queue) + list(arrivals):
                terminal_unadmitted(req, FAILED)
            resume_q.clear()
            queue.clear()
            arrivals.clear()
            stats.node_loss = str(e)
            if __debug__ and self.paged:
                pool.assert_conservation(held_refs=0)

        _sync(cur_tok)
        stats.step_retries = self.supervisor.retries_total - rt0
        if plan is not None:
            stats.faults_injected = plan.injected - f0
        stats.decode_s = max(
            time.perf_counter() - t_run - stats.prefill_s
            - stats.compile_prefill_s - stats.compile_decode_s, 1e-9
        )
        _publish_run_metrics(stats)
        return results, stats

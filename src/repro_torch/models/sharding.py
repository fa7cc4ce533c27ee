"""Sharding rules and the hooks of the sharded train step (counterpart of
``repro/models/sharding.py``).

Strategy, the reference's (DESIGN.md §5):
  * TP over ``model``: Megatron column/row splits (QKV & up-proj column,
    out & down-proj row), vocab-sharded embedding + head.
  * FSDP over ``data`` (+ ``pod`` when present): every matmul weight's
    non-TP dim is additionally sharded ZeRO-3 style and gathered at use.
    Optimizer state inherits the same specs.
  * EP over ``model``: MoE expert stacks shard their expert dim.
  * Caches: KV-head dim over ``model`` when divisible, else the sequence;
    batch over ``data`` (+ ``pod``); SSM state heads over ``model``.

The tables (``param_spec_tree``, ``cache_spec_tree``, ``batch_spec_tree``)
return the reference's specs as tuples of axis names (:class:`P`), keyed
off the leaf names of the port's trees (paths as ``repro_torch.tree``
renders them). The port's layers are lists of per-layer dicts, so its
leaves lack the reference's stacked (L, ...) axes; leading axes of any
leaf are padded with None as there. ``named`` turns a spec into DTensor
placements on a ``DeviceMesh`` (``Shard(dim)`` / ``Replicate()`` per mesh
dim) and ``place`` cuts a whole tree into its local shards.

The hooks: GSPMD partitions the reference's program; here every rank
computes on its LOCAL shards, plain tensors, and the hooks below insert
the collectives that partitioning implies. Under ``mesh_context(mesh)``
(installed by ``launch.train.jitted_train_step`` and ``launch.dryrun``):

  * ``gather_weight`` / ``col_parallel`` / ``row_parallel``: FSDP, the
    weight all-gathered over the data axes at use; its gradient is
    reduce-scattered (summed) back onto the shard.
  * ``enter_tp``: Megatron's *f*, identity forward, the cotangent summed
    over ``model`` backward (the input of a column-parallel product).
  * ``finish_tp``: Megatron's *g*, the row-parallel output summed over
    ``model`` forward, identity backward.
  * ``gather_tp``: a weight (or an activation) gathered over ``model``
    where the ranks use different parts of it (K/V heads that do not
    divide the axis, shared experts under EP, the ssm's packed in_proj
    row); its gradient is summed and cut back.
  * ``tp_sum``: partial sums every ``model`` rank uses (the ssm's gated
    norm): summed forward and backward.

Gradient convention (Megatron's): every rank backpropagates the same
global loss (the data ranks' mean cross-entropy through ``dp_mean``, the
balance loss from factors averaged over the ranks), and with these hooks
each rank's gradient is the whole gradient of its shards. Leaves kept
whole over the data axes get their gradient summed over them by the step.
Without a context every hook is the identity, so the serving path and the
one-device step run the plain code.

Collectives take one path by one rule (``_collective``): a tensor on the
``meta`` device (the dry run, under the ``fake`` process group) and a CPU
tensor go to ``torch.distributed`` directly; a card tensor on a gloo
group is staged through host memory (PERF.md §6 lists what gloo runs on
card tensors; the staged path needs none of it). Each records its kind
and bytes (the result's, as the reference's ``collective_bytes`` counts
them: a reduce-scatter's shard) for ``collective_stats``.
"""
from __future__ import annotations

import contextlib
import re
import threading
import warnings

import torch
import torch.distributed as dist

from repro_torch import tree

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry a tensor dim, each None, an axis name
    or a tuple of axis names (``jax.sharding.PartitionSpec``'s content)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


_KEY = re.compile(r"\['([^']*)'\]")


def _keys(path: str) -> list:
    return _KEY.findall(path)


def _name(path: str) -> str:
    keys = _keys(path)
    return keys[-1] if keys else ""


def param_spec_tree(params_like, cfg, *, fsdp, tp="model"):
    """The spec of every leaf of ``params_like`` (any tree of the port's
    parameter structure whose leaves have ``.shape``)."""
    del cfg

    def rule(path, leaf):
        name = _name(path)
        nd = len(leaf.shape)
        keys = _keys(path)
        # shared experts are plain SwiGLU stacks, not (E, ...) expert stacks
        moe = "moe" in keys and "shared" not in keys
        if name == "embed":
            base = (tp, fsdp)
        elif name == "unembed":
            base = (fsdp, tp)
        elif moe and name in ("w_gate", "w_up"):
            base = (tp, fsdp, None)       # (E, d, ff): experts on TP axis
        elif moe and name == "w_down":
            base = (tp, None, fsdp)       # (E, ff, d)
        elif name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
            base = (fsdp, tp)
        elif name in ("wo", "w_down", "out_proj"):
            base = (tp, fsdp)
        elif name == "router":
            base = (fsdp, None)
        elif name == "conv_w":
            base = (None, tp)
        elif name == "conv_b":
            base = (tp,)
        else:  # norms, gates, A_log, D, dt_bias, ...
            base = ()
        return P(*((None,) * (nd - len(base)) + tuple(base)))

    return tree.map_with_path(rule, params_like)


def _kv_spec(cfg, dp, tp, lead, tp_size=16, seq_shard=False):
    """Spec for a (..., B, S, KV, hd) cache tensor with ``lead`` leading
    axes: KV heads over ``model`` when they divide it, else the cache
    sequence; ``seq_shard`` (global batch below the DP domain) shards the
    sequence over the DP axes too instead of the batch."""
    heads_ok = cfg.n_kv_heads and cfg.n_kv_heads % tp_size == 0
    if seq_shard:
        tail = ((None, dp, tp, None) if heads_ok
                else (None, tuple(dp) + (tp,), None, None))
    else:
        tail = (dp, None, tp, None) if heads_ok else (dp, tp, None, None)
    return P(*((None,) * lead + tail))


def cache_spec_tree(cfg, *, dp, tp="model", tp_size=16, seq_shard=False):
    """Specs of ``models.model.cache_specs``'s tree."""
    fam = cfg.family
    bdp = None if seq_shard else dp

    def kv(lead):
        s = _kv_spec(cfg, dp, tp, lead, tp_size, seq_shard)
        return {"k": s, "v": s}

    if fam in ("dense", "moe"):
        return {"kv": kv(1)}
    if fam == "ssm":
        return {"ssm": P(None, bdp, tp, None, None),
                "conv": P(None, bdp, None, tp)}
    if fam == "hybrid":
        from repro_torch.models.model import _hybrid_shape

        out = {"ssm": P(None, None, bdp, tp, None, None),
               "conv": P(None, None, bdp, None, tp),
               "kv": kv(1)}
        if _hybrid_shape(cfg)[2]:
            out["ssm_tail"] = P(None, bdp, tp, None, None)
            out["conv_tail"] = P(None, bdp, None, tp)
        return out
    if fam == "encdec":
        return {"kv": kv(1), "xkv": kv(1)}
    if fam == "vlm":
        return {"kv": kv(2), "xkv": kv(1)}
    raise ValueError(fam)


def batch_spec_tree(cfg, kind, *, dp, tp="model", tp_size=16,
                    batch_size=None, dp_total=None):
    """Specs of the input batch dict of a shape kind ("train", "prefill",
    "decode"). When ``batch_size`` does not divide over the DP domain
    (long_500k at B=1) batch dims replicate and caches sequence-shard."""
    seq_shard = (batch_size is not None and dp_total is not None
                 and batch_size % dp_total != 0)
    toks = P(None, None) if seq_shard else P(dp, None)
    if kind == "train":
        out = {"tokens": toks, "labels": toks}
    elif kind == "prefill":
        out = {"tokens": toks}
    else:
        out = {"tokens": toks, "position": P(),
               "caches": cache_spec_tree(cfg, dp=dp, tp=tp, tp_size=tp_size,
                                         seq_shard=seq_shard)}
    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["frames"] = P(dp, None, None)
        if cfg.family == "vlm":
            out["patches"] = P(dp, None, None)
    return out


def dp_axes_of(mesh) -> tuple:
    """The data-parallel axis names of a mesh (a ``DeviceMesh``, a
    ``launch.mesh.HostMesh`` or a :class:`Grid`)."""
    return tuple(n for n in _axis_names(mesh) if n in ("pod", "data"))


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ---------------------------------------------------------------------------
# the grid: a mesh's axes, this rank's coordinates and the groups
# ---------------------------------------------------------------------------


class Grid:
    """The sharded step's view of a mesh: axis sizes (``shape``, in mesh
    order), this rank's coordinate on each axis, a process group per axis
    (None on an axis of size 1) and, for tuples of axes, one group over
    their product. Its collective methods (``mean``, ``all_to_all``,
    ``all_gather``) follow the convention above; ``models.moe`` runs its
    means and exchanges through them."""

    def __init__(self, shape: dict, coords: dict, groups: dict,
                 device_mesh=None, host=None):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self._device_mesh = device_mesh
        self._host = host

    def device_mesh_for(self, device_type: str):
        """The ``DeviceMesh`` DTensors of ``device_type`` live on (a
        ``HostMesh`` makes one a device type, collectively, on first use;
        None on a mesh of one process)."""
        if self._device_mesh is not None:
            return self._device_mesh
        if self._host is not None:
            return self._host.device_mesh(device_type)
        return None

    def index(self, axes) -> int:
        """Row-major index of this rank over ``axes`` (a name or tuple)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def group(self, axes):
        axes = _axes(axes)
        return self.groups[axes[0] if len(axes) == 1 else axes]

    def mean(self, t, axis):
        """Mean over ``axis``: forward sum / n, backward identity / n."""
        if self.size(axis) == 1:
            return t
        return _AllReduce.apply(t, self, _axes(axis)) / self.size(axis)

    def all_to_all(self, t, axis):
        """Row q of ``t`` goes to rank q of ``axis``; self-adjoint."""
        return _AllToAll.apply(t, self, _axes(axis))

    def all_gather(self, t, axis, dim):
        """The ranks' ``t`` concatenated along ``dim``: replicated values
        downstream, so the backward keeps this rank's slice."""
        return _Replicate.apply(t, self, _axes(axis), dim)


def grid_of(mesh) -> Grid | None:
    """A :class:`Grid` of ``mesh``: a ``launch.mesh.HostMesh`` (its row and
    column groups), a ``DeviceMesh`` (its dim groups; for the production
    mesh's ("pod", "data") one group over both, made here) or a Grid."""
    if mesh is None or isinstance(mesh, Grid):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names)
        shape = dict(zip(names, mesh.shape))
        coord = mesh.get_coordinate()
        coords = dict(zip(names, coord))
        groups = {n: mesh.get_group(n) if shape[n] > 1 else None
                  for n in names}
        dp = dp_axes_of(mesh)
        if len(dp) > 1:
            groups[dp] = _product_group(mesh, dp, coords)
        return Grid(shape, coords, groups, device_mesh=mesh)
    return Grid(mesh.shape, mesh.coords, mesh.groups, host=mesh)


def _product_group(mesh, axes, coords):
    """One group over the ranks that share this rank's coordinates off
    ``axes`` (row-major over ``axes``); every rank makes every such group,
    in one order."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh
    keep = [i for i, n in enumerate(names) if n in axes]
    other = [i for i, n in enumerate(names) if n not in axes]
    width = 1
    for i in keep:
        width *= ranks.shape[i]
    rows = ranks.permute(*other, *keep).reshape(-1, width).tolist()
    mine_i = 0
    for d in other:
        mine_i = mine_i * ranks.shape[d] + coords[names[d]]
    mine = None
    for i, row in enumerate(rows):
        g = dist.new_group(row)
        if i == mine_i:
            mine = g
    return mine


# ---------------------------------------------------------------------------
# collectives: one path rule, counted
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_stats: dict = {}


def reset_collective_stats() -> None:
    with _stats_lock:
        _stats.clear()


def collective_stats() -> dict:
    """{kind: {"count", "bytes", "staged_bytes"}} since the last reset:
    ``bytes`` the results' (the reference's convention), ``staged_bytes``
    what went through host memory (card tensors on gloo: both ways)."""
    with _stats_lock:
        return {k: dict(v) for k, v in _stats.items()}


def _record(kind: str, result: torch.Tensor, staged: int) -> None:
    with _stats_lock:
        s = _stats.setdefault(kind, {"count": 0, "bytes": 0,
                                     "staged_bytes": 0})
        s["count"] += 1
        s["bytes"] += result.numel() * result.element_size()
        s["staged_bytes"] += staged


def path_of(t: torch.Tensor, group) -> str:
    """"staged" for a card tensor on a gloo group, else "direct" (the
    CPU, and ``meta`` under the fake group)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return "staged"
    return "direct"


def _collective(kind, t, group, fn):
    """Run ``fn(h) -> result`` on ``t`` or its host copy by the rule."""
    t = t.contiguous()
    if path_of(t, group) == "staged":
        h = t.cpu()
        out = fn(h).to(t.device)
        staged = (h.numel() * h.element_size()
                  + out.numel() * out.element_size())
    else:
        out = fn(t)
        staged = 0
    _record(kind, out, staged)
    return out


def _all_gather(t, grid, axes, dim):
    n = grid.size(axes)
    if n == 1:
        return t
    group = grid.group(axes)

    def fn(h):
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim=dim)
    return _collective("all_gather", t, group, fn)


def _all_reduce(t, grid, axes, op=dist.ReduceOp.SUM, kind="all_reduce"):
    if grid.size(axes) == 1:
        return t
    group = grid.group(axes)

    def fn(h):
        h = h.clone()
        dist.all_reduce(h, op=op, group=group)
        return h
    return _collective(kind, t, group, fn)


def _reduce_scatter(t, grid, axes, dim):
    """Sum over ``axes``, this rank's slice of ``dim`` (one
    ``reduce_scatter_tensor`` over ``dim`` moved to the front)."""
    n = grid.size(axes)
    if n == 1:
        return t
    group = grid.group(axes)

    def fn(h):
        front = h.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
        with warnings.catch_warnings():
            # newer releases rename it reduce_scatter_single; both run it
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, front, group=group)
        return out.movedim(0, dim).contiguous()
    return _collective("reduce_scatter", t, group, fn)


def _all_to_all(t, grid, axes):
    if grid.size(axes) == 1:
        return t
    group = grid.group(axes)

    def fn(h):
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out
    return _collective("all_to_all", t, group, fn)


class _Gather(torch.autograd.Function):
    """All-gather forward; reduce-scatter (the adjoint) backward."""

    @staticmethod
    def forward(ctx, t, grid, axes, dim):
        ctx.grid, ctx.axes, ctx.dim = grid, axes, dim
        return _all_gather(t, grid, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.grid, ctx.axes, ctx.dim), None, None, \
            None


class _Replicate(torch.autograd.Function):
    """All-gather forward; this rank's slice backward (every rank holds the
    same cotangent)."""

    @staticmethod
    def forward(ctx, t, grid, axes, dim):
        ctx.grid, ctx.axes, ctx.dim = grid, axes, dim
        return _all_gather(t, grid, axes, dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.grid.size(ctx.axes)
        return (g.chunk(n, dim=ctx.dim)[ctx.grid.index(ctx.axes)]
                .contiguous(), None, None, None)


class _AllReduce(torch.autograd.Function):
    """Megatron's g: sum forward, identity backward."""

    @staticmethod
    def forward(ctx, t, grid, axes):
        return _all_reduce(t, grid, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, sum backward."""

    @staticmethod
    def forward(ctx, t, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grid, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return _all_to_all(t, grid, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.grid, ctx.axes), None, None


# ---------------------------------------------------------------------------
# the context and the hooks
# ---------------------------------------------------------------------------

# one context for the process, not a thread's: autograd runs a card's
# backward (and with it the remat recompute, whose hooks must fire as in
# the forward) on its own worker thread
_ctx = {"grid": None}


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` (None, a Grid, a HostMesh or a DeviceMesh) for
    the hooks of the code run inside, and of the backward it records."""
    old = _ctx["grid"]
    _ctx["grid"] = grid_of(mesh)
    try:
        yield _ctx["grid"]
    finally:
        _ctx["grid"] = old


def active() -> Grid | None:
    """The installed grid, or None."""
    return _ctx["grid"]


def tp_size() -> int:
    g = active()
    return 1 if g is None else g.size("model")


def tp_rank() -> int:
    g = active()
    return 0 if g is None else g.index("model")


def _on(axes):
    """(grid, axes) when a grid is installed and ``axes`` span > 1 rank;
    ``axes`` "dp" stands for the grid's data axes."""
    g = active()
    if g is None:
        return None, ()
    axes = dp_axes_of(g) if axes == "dp" else _axes(axes)
    return (g, axes) if g.size(axes) > 1 else (None, ())


def gather_weight(w, dim):
    """FSDP: ``w``'s shards of ``dim`` gathered over the data axes at use
    (the reference's ``gather_weight`` leaves that dim replicated)."""
    g, axes = _on("dp")
    return w if g is None else _Gather.apply(w, g, axes, dim % w.dim())


def col_parallel(w):
    """Column-parallel weight (d / fsdp, out / tp): gather the FSDP dim,
    keep TP."""
    return gather_weight(w, w.dim() - 2)


def row_parallel(w):
    """Row-parallel weight (in / tp, d / fsdp): keep TP, gather FSDP."""
    return gather_weight(w, w.dim() - 1)


def enter_tp(x):
    """Megatron's f on a replicated input of a ``model``-split region."""
    g, axes = _on("model")
    return x if g is None else _Enter.apply(x, g, axes)


def finish_tp(h):
    """A row-parallel product's partial sums summed over ``model``
    (Megatron's g): the output is replicated over the axis."""
    g, axes = _on("model")
    return h if g is None else _AllReduce.apply(h, g, axes)


def tp_max(t):
    """Max over ``model``, no gradient (the log-sum-exp's shift)."""
    g, axes = _on("model")
    if g is None:
        return t
    return _all_reduce(t.detach(), g, axes, op=dist.ReduceOp.MAX,
                       kind="all_reduce_max")


def dp_mean(t):
    """Mean over the data axes, g-style (each data rank's loss counts
    1/n)."""
    g, axes = _on("dp")
    return t if g is None else _AllReduce.apply(t, g, axes) / g.size(axes)


def gather_tp(w, dim):
    """``w`` gathered over ``model`` where the ranks use different parts
    of it; the gradient summed and cut back."""
    g, axes = _on("model")
    return w if g is None else _Gather.apply(w, g, axes, dim % w.dim())


def tp_sum(t):
    """Partial sums over ``model`` that every rank goes on to use (the
    gated norm's sum of squares): summed forward and, since each rank's
    use is its own part of the loss, the cotangents summed backward."""
    return finish_tp(enter_tp(t))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


class NamedPlacement:
    """A spec on a mesh (the reference's ``NamedSharding``): ``spec``, the
    mesh's :class:`Grid` and the DTensor ``placements``, one a mesh dim."""

    def __init__(self, mesh, spec):
        self.grid = grid_of(mesh)
        self.spec = P(*spec)
        self.placements = placements_of(self.grid, self.spec)

    def __repr__(self):
        return f"NamedPlacement({self.spec!r}, {self.placements!r})"


def placements_of(grid, spec):
    """DTensor placements of ``spec`` on the grid's mesh dims: ``Shard(i)``
    on the mesh dims named in entry i (in that entry's order), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    if grid is None:
        return ()
    out = []
    for name in grid.shape:
        dims = [i for i, e in enumerate(spec) if name in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _is_spec(node) -> bool:
    return isinstance(node, (P, NamedPlacement))


def map_specs(fn, spec_tree):
    """``fn`` over the :class:`P` / :class:`NamedPlacement` leaves of a
    spec tree (dicts, lists, tuples and NamedTuples of specs; a P is a
    tuple, so ``tree.map`` would walk into it)."""
    if spec_tree is None:
        return None
    if _is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    items = [map_specs(fn, c) for c in spec_tree]
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*items)
    return type(spec_tree)(items)


def map_with_specs(fn, data, specs):
    """``fn(leaf, spec)`` over a tree and its like-shaped spec tree (each
    spec a :class:`P` or a :class:`NamedPlacement`, as it stands)."""
    if data is None:
        return None
    if _is_spec(specs):
        return fn(data, specs)
    if isinstance(data, dict):
        return {k: map_with_specs(fn, data[k], specs[k]) for k in data}
    items = [map_with_specs(fn, d, s) for d, s in zip(data, specs)]
    if hasattr(data, "_fields"):
        return type(data)(*items)
    return type(data)(items)


def named(mesh, spec_tree):
    """The spec tree as :class:`NamedPlacement` leaves."""
    return map_specs(lambda s: NamedPlacement(mesh, s), spec_tree)


def local_shape(shape, grid, spec) -> tuple:
    """The local shard's shape of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = grid.size(_axes(e)) if grid is not None else 1
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {e} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def local_shard(full, grid, spec):
    """This rank's block of ``full`` under ``spec`` (a view)."""
    out = full
    for i, e in enumerate(spec):
        axes = _axes(e)
        if grid is None or grid.size(axes) == 1:
            continue
        n = grid.size(axes)
        if out.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(full.shape)} does not "
                             f"divide over {e} ({n} ranks)")
        w = out.shape[i] // n
        out = out.narrow(i, grid.index(axes) * w, w)
    return out


def place(full_tree, mesh, spec_tree):
    """Each leaf's local shard as a DTensor in its placements (a plain
    tensor on a mesh of one process); the local blocks are copies."""
    grid = grid_of(mesh)

    def one(t, s):
        s = s.spec if isinstance(s, NamedPlacement) else s
        return wrap(local_shard(t, grid, s).contiguous().clone(), grid, s,
                    tuple(t.shape))
    return map_with_specs(one, full_tree, spec_tree)


def wrap(local, grid, spec, shape):
    """``local`` as a DTensor of global ``shape`` in ``spec``'s placements
    on the grid's ``DeviceMesh`` of its device type (``local`` itself on a
    mesh of one process)."""
    dm = None if grid is None else grid.device_mesh_for(local.device.type)
    if dm is None:
        return local
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, dm, placements_of(grid, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def unwrap(t):
    """A DTensor's local tensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def spec_of(t, grid) -> P:
    """The spec of a DTensor's placements on the grid (P() for a plain
    tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return P(*((None,) * t.dim()))
    entries = [[] for _ in range(t.dim())]
    for name, pl in zip(grid.shape, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def gather_full(local, grid, spec):
    """The whole tensor from every rank's ``local`` block (a collective
    over the spec's axes; every rank gets it)."""
    out = local
    for i, e in enumerate(spec):
        axes = _axes(e)
        if grid is not None and grid.size(axes) > 1:
            out = _all_gather(out, grid, axes, i)
    return out


def gather_tree(placed_tree, mesh=None):
    """The whole tensors of a tree of DTensors (plain leaves as they are);
    every rank must call it."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not isinstance(t, DTensor):
            return t
        grid = grid_of(mesh) if mesh is not None else grid_of(t.device_mesh)
        return gather_full(t.to_local(), grid, spec_of(t, grid))
    return tree.map(one, placed_tree)

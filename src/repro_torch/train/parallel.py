"""Parameter layouts across ranks: FSDP over "data", tensor parallelism
over "model", replicas over "pod".

JAX's launcher only places each parameter by ``param_specs``
(``NamedSharding`` on every leaf, ``train/sharding_rules.py``) and GSPMD
inserts the collectives, so its step equals the one-device step and its
compute is split wherever a leaf's storage is.  The port has no GSPMD:
this module does the collectives by hand, with the same result.

  * :func:`shard_params` keeps each rank's shard of every leaf: the
    whole leaf narrowed, dimension by dimension, to this rank's block
    along each mesh axis its spec names (``shard_shape``).  The AdamW
    moments are made from the shards and so mirror them (ZeRO).
  * :class:`Layout` holds the mesh, the specs and a process group an
    axis, and gives the train step its three collectives:

    - :meth:`Layout.gather` all-gathers a layer's leaves over "data"
      before use, inside the layer's checkpointed body
      (``models.model.forward``), so remat gathers again in the backward
      and the gathered layer is freed after use; its backward
      reduce-scatters the gradient into the shard.  Over "model" it
      keeps every leaf that the rules split there split, and marks the
      dict that computes with it (:class:`ModelParallel` under ``"tp"``,
      Megatron's "f" on the input and "g" on the partial sums): the
      vocabulary of the embedding and the unembedding (the losses read
      the local logits through a vocab-parallel log-softmax), the heads
      of self-attention, cross-attention and the encoder's attention
      (``wq``, ``wk``, ``wv`` column-parallel, ``wo`` row-parallel), the
      d_ff of the dense MLP and of the shared expert, the experts of an
      MoE (or each expert's d_ff where the model axis does not divide
      the experts), and the heads of a Mamba2 mixer.  Three leaves are
      gathered whole over "model": the mixer's ``in_proj``, ``conv_w``
      and ``conv_b``, whose columns ([z, x, B, C, dt] and [x, B, C])
      do not line up with heads; each rank slices its heads' columns
      from them, and their backward sums the model ranks' parts.
    - :meth:`Layout.reduce` finishes the gradient: an all-reduce over
      "data" for the leaves stored whole there, over "pod" for every
      leaf (HSDP: weight gathers stay in a pod), and over "model" for
      the leaves stored whole there (each rank's gradient is whole after
      the "f" of the compute that reads them); then the mean over the
      row groups and the model ranks' copies.
    - :meth:`Layout.grad_norm` sums each leaf's squares once over its
      shards (a replicated leaf on one rank of its replicas) and
      all-reduces the sum.

At a mesh whose axes all have size 1 every method is the identity and
the step is ``make_train_step``'s bit for bit.  On a mesh of names and
sizes only (``utils.sharding.LogicalMesh``, the dry-run's) each axis has
a :class:`MetaGroup` and the layout computes rank 0's part on meta
tensors: every collective allocates its result as the ``nccl`` branch
does, one output each, and moves no data (``launch.memory``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.utils.sharding import (
    DATA,
    MODEL,
    POD,
    PartitionSpec,
    map_specs,
    mesh_shape,
    spec_axes,
)
from repro_torch.utils.treeutil import (
    global_norm,
    pytree_flatten,
    pytree_unflatten,
    tree_leaves,
    tree_unflatten,
)

# leaves of at most this many bytes share one flat all-reduce
BUCKET_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# Heads of a tensor-parallel rank
# ---------------------------------------------------------------------------
def local_heads(H: int, KV: int, size: int) -> Tuple[int, int]:
    """(query heads, KV heads) the flash kernel sees on model rank 0 of a
    layout that splits ``H`` query heads over ``size`` ranks: the rank's
    heads and the KV heads they read (every rank's, when
    :func:`tp_heads` accepts the split); the heads whole when ``size``
    does not divide them (the rules keep them whole)."""
    if size <= 1 or H % size or KV <= 0 or H % KV:
        return H, KV
    h_loc, group = H // size, H // KV
    return h_loc, (h_loc - 1) // group + 1


def tp_heads(H: int, KV: int, size: int, rank: int
             ) -> Tuple[int, int, int, int]:
    """(h_lo, h_hi, kv_lo, kv_hi): the query heads model rank ``rank`` of
    ``size`` computes and the KV heads they read.  Query head h reads KV
    head ``h // (H / KV)``, its *global* index: when ``KV % size != 0``
    the rules keep ``wk``/``wv`` whole and each rank slices the heads
    its queries map to.  The flash kernel maps a local query head j to
    local KV head ``j // (H_loc / KV_loc)``; that equals the global
    mapping only when the local heads cover whole groups or lie inside
    one (``H_loc % G == 0`` or ``G % H_loc == 0``, G = H / KV).  Any
    other split raises (flowlint pass 3 reports it as K106)."""
    if H % size or H % KV:
        raise ValueError(f"{H} query heads over {size} model ranks with "
                         f"{KV} KV heads")
    h_loc, kv_loc = local_heads(H, KV, size)
    group = H // KV
    if h_loc % group and group % h_loc:
        raise ValueError(
            f"{h_loc} query heads a rank split groups of {group}: the "
            "flash kernel's local GQA map would read the wrong KV heads")
    h_lo = rank * h_loc
    return h_lo, h_lo + h_loc, h_lo // group, h_lo // group + kv_loc


# ---------------------------------------------------------------------------
# Collectives with their conjugates as autograd functions
# ---------------------------------------------------------------------------
def _dist():
    import torch.distributed as dist
    return dist


@dataclass(frozen=True)
class MetaGroup:
    """A mesh axis of a :class:`~repro_torch.utils.sharding.LogicalMesh`
    in place of a process group: its size, this process its rank 0.  A
    collective over it takes meta tensors only: it allocates what the
    ``nccl`` branch allocates and moves nothing."""
    size: int


def _meta(group, x: torch.Tensor) -> bool:
    """Whether a collective over ``group`` takes the meta route."""
    if not isinstance(group, MetaGroup):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a mesh of names and sizes takes meta tensors, "
                         f"got one on {x.device}")
    return True


def _all_reduce(x: torch.Tensor, group=None, op=None) -> None:
    """``dist.all_reduce`` in place (the sum unless ``op``); nothing on
    the meta route."""
    if _meta(group, x):
        return
    dist = _dist()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)


def _contiguous_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` from every rank of ``group``, concatenated
    along ``dim`` in group-rank order."""
    x = x.movedim(dim, 0).contiguous()
    if _meta(group, x):
        return x.new_empty((group.size * x.shape[0],)
                           + tuple(x.shape[1:])).movedim(0, dim)
    dist = _dist()
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's block along ``dim``
    (gloo has no reduce-scatter: it all-reduces and takes the block)."""
    x = _contiguous_copy(x.movedim(dim, 0))
    if _meta(group, x):
        k = x.shape[0] // group.size
        return x.new_empty((k,) + tuple(x.shape[1:])).movedim(0, dim)
    dist = _dist()
    n = dist.get_world_size(group)
    k = x.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((k,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
    else:
        dist.all_reduce(x, group=group)
        r = dist.get_rank(group)
        out = x[r * k:(r + 1) * k]
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _Enter(torch.autograd.Function):
    """Megatron's "f": the identity forward, an all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = _contiguous_copy(grad)
        _all_reduce(g, ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    """Megatron's "g": an all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = _contiguous_copy(x)
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Total(torch.autograd.Function):
    """An all-reduce forward and backward: a sum every rank reads whose
    terms each rank computed in part, and whose readers each hold only
    their part of its gradient (the split norm's sum of squares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _contiguous_copy(x)
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = _contiguous_copy(grad)
        _all_reduce(g, ctx.group)
        return g, None


@dataclass(frozen=True)
class ModelParallel:
    """The marker a dict split over the model axis carries under the key
    ``"tp"`` (attention, MLP, MoE, a Mamba2 mixer, the embedding): its
    input enters through :meth:`enter` (a partial gradient on each model
    rank, summed backward), its row-parallel output leaves through
    :meth:`exit` (partial sums, summed forward), and a sum over a split
    dimension that every rank reads goes through :meth:`total`."""
    group: Any
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(y, self.group)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return _Total.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest ``x`` over the model ranks (no gradient)."""
        y = _contiguous_copy(x.detach())
        _all_reduce(y, self.group, _dist().ReduceOp.MAX)
        return y


@dataclass(frozen=True)
class RowParallel:
    """The marker an MoE dict carries under the key ``"rows"`` when the
    batch is split over row groups: the capacity dispatch and the aux
    loss read the whole batch (JAX's MoE is one computation over the
    global batch), so the block's input is all-gathered over "data" and
    then "pod" (pod-major, as ``array_batch_specs`` splits the rows) and
    each rank keeps its rows of the output."""
    groups: Tuple[Any, ...]  # the data group, then the pod group
    index: int
    count: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for group in self.groups:
            x = _AllGather.apply(x, 0, group)
        return x

    def local(self, y: torch.Tensor) -> torch.Tensor:
        b = y.shape[0] // self.count
        return y[self.index * b:(self.index + 1) * b]


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------
def _flat_specs(specs: Any) -> List[PartitionSpec]:
    out: List[PartitionSpec] = []
    map_specs(out.append, specs)
    return out


def _spec_at(spec: PartitionSpec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """The axes of the last ``ndim`` dimensions of ``spec``: a stacked
    leaf's spec on one layer's slice (the stacked dims are never
    sharded); a spec shorter than the tensor replicates the rest."""
    axes = spec_axes(spec) + ((),) * max(ndim - len(spec), 0)
    lead = len(axes) - ndim
    assert not any(axes[:lead]), (spec, ndim)
    return axes[lead:]


def _coords(mesh: Any) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return {a: 0 for a in mesh_shape(mesh)}
    return dict(zip(names, mesh.get_coordinate()))


def _axis_of(axes: Tuple[str, ...]) -> str:
    assert len(axes) == 1, f"one mesh axis a dimension, got {axes}"
    return axes[0]


def shard_params(params: Any, mesh: Any, specs: Any) -> Any:
    """Each rank's shard of every leaf of ``params`` (the same whole
    values on every rank) by ``specs``: a contiguous copy of this rank's
    block along every named axis, the leaf itself where no axis of size
    above 1 splits it."""
    sizes, coords = mesh_shape(mesh), _coords(mesh)
    leaves, treedef = pytree_flatten(params)
    out = []
    for x, spec in zip(leaves, _flat_specs(specs)):
        y = x
        for d, axes in enumerate(spec_axes(spec)):
            if not axes or sizes[_axis_of(axes)] == 1:
                continue
            a = _axis_of(axes)
            k = x.shape[d] // sizes[a]
            y = y.narrow(d, coords[a] * k, k)
        out.append(y if y is x else y.clone())
    return pytree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------
@dataclass
class Layout:
    """A param tree's layout on a mesh: the mesh, the spec tree (from
    ``param_specs``, for the whole leaves) and a process group for each
    axis of size above 1 (a :class:`MetaGroup` on a mesh of names and
    sizes only: rank 0's compute on meta tensors)."""
    mesh: Any
    specs: Any
    sizes: Dict[str, int] = field(init=False)
    coords: Dict[str, int] = field(init=False)
    groups: Dict[str, Any] = field(init=False)
    world: Any = field(init=False)  # the group of every rank

    def __post_init__(self):
        self.sizes = mesh_shape(self.mesh)
        self.coords = _coords(self.mesh)
        logical = not hasattr(self.mesh, "get_group")
        self.groups = {a: MetaGroup(n) if logical else self.mesh.get_group(a)
                       for a, n in self.sizes.items() if n > 1}
        self.world = MetaGroup(math.prod(self.sizes.values())) \
            if logical else None

    # -- sizes ---------------------------------------------------------------
    @property
    def model(self) -> int:
        return self.sizes.get(MODEL, 1)

    @property
    def row_groups(self) -> int:
        """The number of distinct batch shards: data x pod."""
        return self.sizes.get(DATA, 1) * self.sizes.get(POD, 1)

    # -- gather --------------------------------------------------------------
    def _spec(self, path: Tuple[str, ...]):
        s = self.specs
        for k in path:
            s = s[k]
        return s

    def _whole(self, x: torch.Tensor, spec: PartitionSpec,
               keep: Tuple[str, ...] = ()) -> torch.Tensor:
        """``x`` gathered along every axis of its spec but ``keep``.  A
        split over "model" must be kept: gathered, every model rank would
        compute the leaf whole (the launcher refuses such a mesh by
        ``model_axis_misses``)."""
        for d, axes in enumerate(_spec_at(spec, x.dim())):
            if not axes:
                continue
            a = _axis_of(axes)
            if a in keep or a not in self.groups:
                continue
            if a == MODEL:
                raise ValueError(
                    f"a leaf of shape {tuple(x.shape)} stored split over "
                    f"\"model\" by {spec} would be computed whole on every "
                    f"model rank")
            x = _AllGather.apply(x, d, self.groups[a])
        return x

    def _whole_tree(self, tree: Any, specs: Any,
                    keep: Tuple[str, ...] = ()) -> Any:
        if isinstance(tree, dict):
            return {k: self._whole_tree(v, specs[k], keep)
                    for k, v in tree.items()}
        return self._whole(tree, specs, keep)

    def gather(self, tree: Any, *path: str) -> Any:
        """``tree`` (the params at ``path``: a leaf, a layer's dict, a
        stacked group's, or part of the embedding's dict) as its compute
        reads it on this rank: gathered over "data" and "pod", split over
        "model" as the rules store it, each split dict marked; an "moe"
        dict also carries the row groups' marker."""
        if not self.groups:
            return tree
        specs = self._spec(path)
        if not isinstance(tree, dict):
            return self._whole(tree, specs)
        if path == ("embed",):
            return self._vocab(tree, specs)
        out = {}
        for k, v in tree.items():
            out[k] = self._part(k, v, specs[k])
            if k == "moe" and self.row_groups > 1:
                out[k]["rows"] = self._rows()
        return out

    def _part(self, k: str, v: Any, s: Any) -> Any:
        if self.model > 1 and isinstance(v, dict):
            if k in ("attn", "xattn") and self._splits(s["wq"], -2):
                return self._tp_attention(v, s)
            if k in ("mlp", "shared") and self._splits(s["gate"], -1):
                return self._tp_mlp(v, s)
            if k == "moe" and (self._splits(s["gate"], -3)
                               or self._splits(s["gate"], -1)):
                return self._tp_moe(v, s)
            if k == "mixer" and self._splits(s["out_proj"], -2):
                return self._tp_mixer(v, s)
        return self._whole_tree(v, s)

    def _rows(self) -> RowParallel:
        groups = tuple(self.groups[a] for a in (DATA, POD)
                       if a in self.groups)
        index = (self.coords.get(POD, 0) * self.sizes.get(DATA, 1)
                 + self.coords.get(DATA, 0))
        return RowParallel(groups, index, self.row_groups)

    def _splits(self, spec: PartitionSpec, dim: int) -> bool:
        axes = spec_axes(spec)
        return len(axes) >= -dim and MODEL in axes[dim]

    def _marker(self) -> ModelParallel:
        return ModelParallel(self.groups[MODEL], self.coords[MODEL],
                             self.model)

    def _vocab(self, p: Dict[str, Any], s: Dict[str, Any]):
        """The embedding's ``tokens`` or ``unembed`` with this model
        rank's rows (columns) of the padded vocabulary, marked; whole
        when the rules keep the vocabulary whole on "model"."""
        dims = {"tokens": -2, "unembed": -1}
        if self.model == 1 or not all(self._splits(s[k], dims[k])
                                      for k in p):
            return self._whole_tree(p, s)
        out = self._whole_tree(p, s, (MODEL,))
        out["tp"] = self._marker()
        return out

    def _tp_attention(self, p: Dict[str, Any], s: Dict[str, Any]):
        """An attention dict (self-attention, cross-attention) on this
        model rank: local query heads (``wq``, ``wo`` as stored), the KV
        heads they read (``wk``, ``wv`` as stored when split, else sliced
        from the whole), the biases sliced to those heads and the q/k
        norms whole; a leaf stored whole over "model" enters through
        "f", since each rank adds only its heads' part to its gradient."""
        tp = self._marker()
        keep = (MODEL,)
        H_loc = p["wq"].shape[-2]
        kv_split = self._splits(s["wk"], -2)
        KV = p["wk"].shape[-2] * (self.model if kv_split else 1)
        h_lo, h_hi, kv_lo, kv_hi = tp_heads(H_loc * self.model, KV,
                                            self.model, tp.rank)

        def heads(name, lo, hi):
            x = self._whole(p[name], s[name], keep)
            return tp.enter(x)[..., lo:hi, :]

        out: Dict[str, Any] = {
            "wq": self._whole(p["wq"], s["wq"], keep),
            "wo": self._whole(p["wo"], s["wo"], keep)}
        for name in ("wk", "wv"):
            out[name] = (self._whole(p[name], s[name], keep) if kv_split
                         else heads(name, kv_lo, kv_hi))
        if "bq" in p:
            out["bq"] = heads("bq", h_lo, h_hi)
            out["bk"] = heads("bk", kv_lo, kv_hi)
            out["bv"] = heads("bv", kv_lo, kv_hi)
        for name in ("q_norm", "k_norm"):
            if name in p:
                out[name] = {"scale": tp.enter(self._whole(
                    p[name]["scale"], s[name]["scale"]))}
        out["tp"] = tp
        return out

    def _tp_mlp(self, p: Dict[str, Any], s: Dict[str, Any]):
        """A SwiGLU MLP (dense or an MoE's shared expert) on this model
        rank: its d_ff columns of ``gate`` and ``up``, its rows of
        ``down``."""
        out = self._whole_tree(p, s, (MODEL,))
        out["tp"] = self._marker()
        return out

    def _tp_moe(self, p: Dict[str, Any], s: Dict[str, Any]):
        """An MoE dict on this model rank: its experts' ``gate``, ``up``
        and ``down`` as stored (E / m experts, or every expert's d_ff / m
        where the model axis does not divide the experts), the router
        whole (each rank routes the whole batch), the shared expert split
        as a dense MLP."""
        out = {k: (self._part(k, v, s[k]) if k == "shared"
                   else self._whole(v, s[k], (MODEL,)))
               for k, v in p.items()}
        out["tp"] = self._marker()
        return out

    def _tp_mixer(self, p: Dict[str, Any], s: Dict[str, Any]):
        """A Mamba2 mixer on this model rank: ``out_proj``'s rows of its
        heads as stored; ``in_proj``, ``conv_w`` and ``conv_b`` all-gathered
        whole over "model", their backward summed there (each rank slices
        its heads' columns and the whole B and C from them, so its
        gradient is its part); the replicated leaves whole
        (``models.ssm`` slices them to the local heads through "f")."""
        out = self._whole_tree(p, s, (MODEL,))
        for k in ("in_proj", "conv_w", "conv_b"):
            if self._splits(s[k], -1):
                out[k] = _AllGather.apply(out[k], out[k].dim() - 1,
                                          self.groups[MODEL])
        out["tp"] = self._marker()
        return out

    # -- gradients -------------------------------------------------------------
    def reduce(self, grads: Any) -> Any:
        """The step's gradient from each rank's (after the gathers'
        reduce-scatters): summed over the axes a leaf is stored whole
        on, averaged over the model ranks' copies and over the row
        groups, in f32, each leaf cast back to its type."""
        if not self.groups:
            return grads
        leaves = tree_leaves(grads)
        work = [g.float().contiguous() for g in leaves]
        axes = [set(a for ax in spec_axes(s) for a in ax)
                for s in _flat_specs(self.specs)]
        for a in (DATA, POD, MODEL):
            if a in self.groups:
                idx = [i for i, named in enumerate(axes) if a not in named]
                _all_reduce_leaves(work, idx, self.groups[a])
        out = []
        for g, w, named in zip(leaves, work, axes):
            n = self.row_groups * (self.model if MODEL not in named else 1)
            out.append((w.div_(n) if n > 1 else w).to(g.dtype))
        return tree_unflatten(grads, out)

    def _counted(self) -> List[bool]:
        """Whether this rank counts each leaf in a norm: the rank at
        coordinate 0 of every axis the leaf is stored whole on."""
        out = []
        for s in _flat_specs(self.specs):
            named = set(a for ax in spec_axes(s) for a in ax)
            out.append(all(self.coords[a] == 0 for a in self.groups
                           if a not in named))
        return out

    def grad_norm(self, grads: Any) -> torch.Tensor:
        """The global norm of the whole gradient: each leaf's squares
        summed once over its shards, the sum all-reduced."""
        if not self.groups:
            return global_norm(grads)

        def reduce(total):
            total = total.reshape(1).clone()
            _all_reduce(total, self.world)
            return total[0]

        return global_norm(grads, counted=self._counted(), reduce=reduce)

    # -- whole leaves ------------------------------------------------------------
    @torch.no_grad()
    def full(self, tree: Any, to_cpu: bool = False) -> Any:
        """``tree`` (laid out as the params: the params, or an AdamW
        moment) with every leaf whole on every rank, leaf by leaf; on
        the host when ``to_cpu``."""
        leaves, treedef = pytree_flatten(tree)
        out = []
        for x, spec in zip(leaves, _flat_specs(self.specs)):
            for d, axes in enumerate(spec_axes(spec)):
                if axes and _axis_of(axes) in self.groups:
                    x = all_gather(x, d, self.groups[_axis_of(axes)])
            out.append(x.cpu() if to_cpu else x.contiguous())
        return pytree_unflatten(treedef, out)


def _all_reduce_leaves(leaves: List[torch.Tensor], idx: List[int],
                       group) -> None:
    """Sum the contiguous f32 ``leaves[i]`` for ``i`` in ``idx`` over
    ``group``: small ones through flat buckets (the list's entries
    replaced by views of the bucket), a large one in place."""
    bucket: List[int] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
        _all_reduce(flat, group)
        off = 0
        for i in bucket:
            n = leaves[i].numel()
            leaves[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
        bucket, size = [], 0

    for i in idx:
        nbytes = leaves[i].numel() * 4
        if nbytes > BUCKET_BYTES:
            _all_reduce(leaves[i], group)
            continue
        if size + nbytes > BUCKET_BYTES:
            flush()
        bucket.append(i)
        size += nbytes
    flush()


__all__ = ["Layout", "MetaGroup", "ModelParallel", "RowParallel",
           "all_gather", "local_heads", "reduce_scatter", "shard_params",
           "tp_heads"]

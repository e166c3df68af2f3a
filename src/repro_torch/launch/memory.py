"""The live bytes of one step on the meta device: the dry-run's peak.

JAX's dry-run compiles each step and reads XLA's memory analysis:
argument, output, temporary and aliased bytes, and their sum
``argument + temp + output - alias`` as the peak estimate.  The port has
no compiler to ask, so it runs the step itself on meta tensors (shapes
and types, no storage) under :class:`LiveBytes`, a ``TorchDispatchMode``
that counts the bytes of every storage an operator creates and drops
them when the storage's last reference dies (a view adds nothing), and
keeps the peak.  Tensors that autograd saves for the backward stay live
through their storages, as on the card, and each kernel launch is its
footprint (``kernels.meta``): the scores and chunk products of the
kernels' plain versions are never live, as the kernels never write them.

The step is the one the launcher runs, on rank 0 of the mesh, with no
process group (:func:`peak_estimate`): the whole params made on the meta
device, rank 0's shard of each leaf by ``param_specs`` and its rows of
the batch, and ``make_train_step`` (forward, backward, the microbatches'
accumulation, AdamW in place) or ``make_prefill_step`` through
``train.parallel.Layout`` on the logical mesh, whose collectives only
allocate their results there.  A decode step runs ``decode_step`` on
rank 0's rows with every head whole: the port has no decode split over
"model" (the rules split the cache's heads or its sequence there), so
its temporaries are those of a whole-head step, an upper bound of a
split one; its arguments and outputs are the rules' shards.

The figures (:class:`StepBytes`), in JAX's terms: ``argument`` is what
is live when the step is entered (params, AdamW moments, batch; decode
state and token); ``output`` what the step returns on the device (the
step count and the learning rate are host numbers in the port);
``alias`` the outputs that are arguments (AdamW writes the params and
moments in place, so a train step's outputs alias its arguments, as
JAX's donated ones do; the port's decode step writes a new state);
``temp`` the peak less the arguments and the outputs that are not
arguments, so that JAX's formula gives back the measured peak.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_model
from repro_torch.models import model as M
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.parallel import Layout
from repro_torch.train.sharding_rules import (
    array_batch_specs,
    decode_state_specs,
    param_specs,
)
from repro_torch.train.trainer import (
    TrainHParams,
    make_prefill_step,
    make_train_step,
    policy_loss,
)
from repro_torch.utils.roofline import per_device_bytes
from repro_torch.utils.sharding import (
    MODEL,
    LogicalMesh,
    PartitionSpec,
    map_specs,
    shard_shape,
)
from repro_torch.utils.treeutil import pytree_flatten, pytree_unflatten

META = torch.device("meta")


def _kind(func) -> str:
    """"pure" when ``func`` writes no argument and returns no view of one,
    "inplace" when it writes its first argument and returns it, else
    "other"."""
    schema = func._schema
    rets = [r.alias_info for r in schema.returns]
    args = [a.alias_info for a in schema.arguments]
    if not any(r is not None for r in rets) and \
            not any(a is not None and a.is_write for a in args):
        return "pure"
    if len(rets) == 1 and rets[0] is not None and rets[0].is_write and \
            args and args[0] is not None and args[0].is_write and \
            not any(a is not None and a.is_write for a in args[1:]):
        return "inplace"
    return "other"


def _describe(x: Any) -> Any:
    """A hashable description of an operator's argument: a tensor's
    metadata, a sequence's items, any other hashable value as it is."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple([_describe(v) for v in x])
    hash(x)
    return x


def _storages(tree: Any) -> Dict[int, int]:
    """{storage id: bytes} of the meta tensors of ``tree``."""
    out = {}
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == "meta":
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _result(out: Any, args: Any) -> Any:
    """What a fresh meta result of a pure operator is made from again
    (its shape, strides and type), or False when it is anything else
    (``_unsafe_view``, unannotated, returns its argument's storage)."""
    ts = (out,) if isinstance(out, torch.Tensor) else out
    if not isinstance(ts, (list, tuple)) or not all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            and t.storage_offset() == 0 for t in ts):
        return False
    held = _storages(args)
    if any(id(t.untyped_storage()) in held for t in ts):
        return False
    return (isinstance(out, torch.Tensor), type(out),
            tuple((t.shape, t.stride(), t.dtype) for t in ts))


def _remake(made: Any) -> Any:
    single, kind, metas = made
    ts = [torch.empty_strided(shape, stride, dtype=dtype, device=META)
          for shape, stride, dtype in metas]
    return ts[0] if single else kind(ts)


def _meta_of(t: torch.Tensor) -> Tuple:
    return (t.shape, t.stride(), t.dtype, t.storage_offset())


class MetaMemo(TorchDispatchMode):
    """Meta operators without their meta functions where possible.

    A meta operator's result depends on its arguments' shapes, strides
    and types only.  A pure operator (no argument written, no view
    returned) met again with the same ones gets fresh results of the
    recorded shapes, strides and types (``torch.empty_strided``); an
    in-place one on a meta tensor, whose data there is none, returns
    that tensor again when its first run left its shape, strides and
    type as they were.  Over a model's repeated layers and microbatches
    that skips the Python meta functions of most operators; a mode
    above this one sees the same operators and results."""

    def __init__(self):
        super().__init__()
        self._kinds: Dict[Any, str] = {}
        self._made: Dict[Any, Any] = {}

    def run(self, func, args, kwargs):
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        if kind == "other" or (kind == "inplace" and not (
                isinstance(args[0], torch.Tensor)
                and args[0].device.type == "meta")):
            return func(*args, **kwargs)
        try:
            key = (func, _describe(args),
                   _describe(tuple(kwargs.items())) if kwargs else ())
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        made = self._made.get(key)
        if made:
            return args[0] if kind == "inplace" else _remake(made)
        if kind == "inplace":
            before = _meta_of(args[0])
            out = func(*args, **kwargs)
            if made is None:
                self._made[key] = out is args[0] and \
                    _meta_of(out) == before
            return out
        out = func(*args, **kwargs)
        if made is None:
            self._made[key] = _result(out, (args, kwargs))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.run(func, args, kwargs or {})


class LiveBytes(MetaMemo):
    """Bytes of the meta storages alive under it: each operator's outputs
    counted when it creates their storage, dropped when the storage's
    last reference dies; the peak, the operator at which it fell and
    that operator's index among those run.  Its operators run as
    :class:`MetaMemo` runs them."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.peak_op: Any = ""
        self.peak_index = 0
        self.ops = 0
        self._bytes: Dict[int, Tuple[int, Any]] = {}

    def add(self, tree: Any) -> int:
        """Count the storages of ``tree``'s meta tensors not counted yet
        (arguments made before the step); returns the bytes added."""
        before = self.live
        for t in _leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self._mark("(arguments)")
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._bytes:
            return
        n = st.nbytes()
        self._bytes[key] = (n, weakref.ref(st, lambda _, k=key:
                                           self._drop(k)))
        self.live += n

    def _drop(self, key: int) -> None:
        self.live -= self._bytes.pop(key)[0]

    def _mark(self, op: Any) -> None:
        if self.live > self.peak:
            self.peak, self.peak_op, self.peak_index = self.live, op, self.ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self.run(func, args, kwargs or {})
        self.ops += 1
        if isinstance(out, torch.Tensor):
            self._add(out)
        else:
            for t in _leaves(out):
                if isinstance(t, torch.Tensor):
                    self._add(t)
        self._mark(func)
        return out


class StepBytes(NamedTuple):
    """One step's bytes on rank 0 (see the module docstring), with the
    operator at the peak and the number of operators run."""
    argument: int
    output: int
    alias: int
    temp: int
    peak: int
    end: int
    peak_op: str
    peak_index: int
    ops: int

    def memory(self) -> Dict[str, int]:
        """JAX's keys: argument, output, temp, alias and peak estimate
        (``argument + temp + output - alias``) bytes."""
        return {"argument_bytes": self.argument,
                "output_bytes": self.output, "temp_bytes": self.temp,
                "alias_bytes": self.alias,
                "peak_est_bytes": self.argument + self.temp + self.output
                - self.alias}


def trace_step(fn: Callable[..., Any], *args) -> Tuple[StepBytes, Any]:
    """Run ``fn(*args)`` on meta tensors under :class:`LiveBytes`, with
    ``args`` live throughout (the caller holds them); returns its figures
    and what it returned."""
    mode = LiveBytes()
    with mode:
        entry = mode.add(args)
        out = fn(*args)
        end = mode.live
    held = _storages(args)
    made = _storages(out)
    alias = sum(n for k, n in made.items() if k in held)
    fresh = sum(n for k, n in made.items() if k not in held)
    return StepBytes(entry, alias + fresh, alias,
                     mode.peak - entry - fresh, mode.peak, end,
                     str(mode.peak_op), mode.peak_index, mode.ops), out


def meta_model(cfg: ModelConfig, dtype: torch.dtype) -> Any:
    """``cfg``'s whole params on the meta device, in ``dtype``."""
    with MetaMemo():
        return init_model(torch.Generator().manual_seed(0), cfg, dtype,
                          META)


def _mesh(mesh: Any) -> LogicalMesh:
    if isinstance(mesh, dict):
        return LogicalMesh(tuple(mesh), tuple(mesh.values()))
    return LogicalMesh(tuple(mesh.axis_names), tuple(mesh.sizes))


def _meta_like(tree: Any) -> Any:
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in tree.items()}


def rank0(tree: Any, mesh: Any, specs: Any) -> Any:
    """Rank 0's shard of every leaf of ``tree`` by ``specs``, each a
    fresh meta tensor of its shard's shape (as the launcher's contiguous
    shards); a dimension may be split over several axes (a batch over
    ("pod", "data"))."""
    leaves, treedef = pytree_flatten(tree)
    flat: list = []
    map_specs(flat.append, specs)
    return pytree_unflatten(treedef, [
        torch.empty(shard_shape(mesh, tuple(x.shape), spec), dtype=x.dtype,
                    device=META) for x, spec in zip(leaves, flat)])


def peak_estimate(cfg: ModelConfig, mesh: Any, *, phase: str = "train",
                  batch: Optional[Dict[str, Any]] = None,
                  hp: Optional[TrainHParams] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  loss_fn=policy_loss, decode_rows: int = 0,
                  cache_len: int = 0) -> StepBytes:
    """One step of ``cfg`` on rank 0 of ``mesh`` (a ``LogicalMesh`` or
    {axis: size}), params in ``dtype``:

      * ``phase="train"``: ``make_train_step(cfg, hp, loss_fn)`` through a
        ``Layout`` on ``batch`` (the global batch: any tensors, whose
        shapes and types are taken) with f32 AdamW moments;
      * ``"prefill"``: ``make_prefill_step`` through the layout;
      * ``"decode"``: one ``decode_step`` of ``decode_rows`` rows (the
        global batch) against a state of ``cache_len`` positions in
        ``dtype``, a token (B, 1) int32 and one int32 position.
    """
    mesh = _mesh(mesh)
    whole = meta_model(cfg, dtype)
    specs = param_specs(mesh, cfg, whole)
    if phase == "decode":
        return _decode_bytes(cfg, mesh, whole, specs, decode_rows,
                             cache_len, dtype)
    params = rank0(whole, mesh, specs)
    del whole
    gbatch = _meta_like(batch)
    rows = rank0(gbatch, mesh, array_batch_specs(mesh, gbatch))
    layout = Layout(mesh, specs)
    if phase == "prefill":
        step = make_prefill_step(cfg, hp, layout=layout)
        return trace_step(step, params, rows)[0]
    step = make_train_step(cfg, hp or TrainHParams(), loss_fn, layout=layout)
    return trace_step(step, params, init_adamw(params), rows)[0]


def _decode_bytes(cfg, mesh, whole, specs, B: int, cache_len: int,
                  dtype) -> StepBytes:
    """The decode step's figures: arguments and outputs by the rules'
    shards (params, state, token and position; logits and the new
    state), the temporaries of ``decode_step`` on rank 0's rows with
    every head whole."""
    state = M.init_decode_state(cfg, B, cache_len, dtype, META)
    token = torch.empty((B, 1), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    sspecs = decode_state_specs(mesh, cfg, state)
    row = array_batch_specs(mesh, {"token": token})
    local = rank0({"state": state, "token": token}, mesh,
                  {"state": _rows_only(sspecs), **row})
    got, (logits, _) = trace_step(
        lambda p, t, s, q: M.decode_step(p, cfg, t, s, q),
        whole, local["token"], local["state"], pos)
    argument = (per_device_bytes(mesh, whole, specs)
                + per_device_bytes(mesh, state, sspecs)
                + per_device_bytes(mesh, token, row["token"])
                + pos.element_size())
    # rank 0's rows of the logits, as the rules split them; the new state
    # laid out as the old
    output = (logits.untyped_storage().nbytes()
              + per_device_bytes(mesh, state, sspecs))
    alias = _passed_through(mesh, state, sspecs)
    return got._replace(argument=argument, output=output, alias=alias)


def _rows_only(specs: Any) -> Any:
    """``specs`` with "model" dropped: rank 0's rows, every head whole."""
    def drop(spec):
        return PartitionSpec(*(
            None if e == MODEL else
            tuple(a for a in e if a != MODEL) or None
            if isinstance(e, tuple) else e for e in spec))

    return map_specs(drop, specs)


def _passed_through(mesh, state, sspecs) -> int:
    """Bytes a device holds of the decode state's leaves that
    ``decode_step`` returns as they came (the cached cross K/V)."""
    return per_device_bytes(mesh, state.cross_kv, sspecs.cross_kv)

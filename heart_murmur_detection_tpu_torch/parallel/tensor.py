"""Megatron tensor parallelism over the model axis of a TensorParallelMesh
(parallel/mesh.py) — counterpart of heart_murmur_detection_tpu/parallel/
mesh.py (`_megatron_spec` :69, `_fsdp_spec` :92, `transformer_param_specs`
:122, `optimizer_shardings` :163, `place_like` :246).

The placement is the JAX rule, read on the port's parameter names: a flax
Dense kernel (in, out) is a torch Linear weight (out, in) under the same
module path (the port keeps the reference's names; extract/convert.py maps
one onto the other), so the JAX column split P(None, 'model') of a kernel
is Shard(0) of the weight and the row split P('model', None) is Shard(1).
- column-parallel: 2-D weights whose module name ends in qkv or fc1 (the
  swin, ViT and SwinV2-CR blocks' qkv and mlp.fc1, the decoder's
  meta_mlp.fc1, a fine-tuning MLP head's fc1);
- row-parallel: 2-D weights of an attention proj (attn.proj) or a module
  ending in fc2 (mlp.fc2, meta_mlp.fc2, the MLP head's fc2);
- everything else replicated: the patch embed's conv (4-D), biases, norms,
  tables, and any dimension that the model axis does not divide.
fsdp_dim is `_fsdp_spec` (the largest divisible flax axis of a parameter of
at least min_size elements), for the table only: at run time ZeRO-3 is
parallel/mesh.py::ZeroShard, one flat shard a rank.

At run time a column-parallel qkv whose head count the model axis divides
is split by heads, not into contiguous blocks of its 3C rows as GSPMD
splits the kernel: each model rank holds the q, k and v rows of its heads /
n_model heads, so attention needs no collective. Where the heads do not
divide (ViT-S's 6 heads at tp=4, an HTS-AT stage's 4 heads at tp=8), the
block takes the head split: the rank holds the contiguous block of 3C /
n_model rows, as GSPMD splits the kernel, and models/tp_blocks.py
all-gathers the qkv activations (`gather`), runs attention over every head
on every model rank, and hands the rank's C / n_model columns of the head
outputs to the row-parallel proj (`split`). Either way the shape is 3C /
n_model rows, and the full tensor gathered for a checkpoint is the
single-device layout.

Replicated parameters come in two kinds (Placement.kind):
- used whole on every model rank (norms, the patch embed, a row-parallel
  layer's bias, added after the all-reduce, ...): their gradients are equal
  on the model peers, because a column-parallel layer's input passes
  through `copy` (identity forward, all-reduce backward);
- used as a slice ("slice": a column-parallel layer's bias, the swin
  relative-position table's columns of the local heads, the SwinV2-CR
  per-head tau): each rank's gradient is nonzero only in its slice, so
  reduce_slices sums them over the model axis.
In a head-split block the tables and tau are used whole: every model rank
runs attention over all heads, and `split`'s backward all-gathers the head
outputs' cotangent, so the attention's backward, and with it these
gradients and the gathered qkv's, are the same on every model rank
(`gather`'s backward then keeps the rank's part, with no collective).
Every gradient is then summed over the data axis only (all_reduce_grads).

shard_model places a model: the sharded parameters keep their Parameter
objects with this rank's rows or columns as data, and every parameter with
a placement carries it as `p.tp`; every module carries the mesh as
`tp_mesh`, which models/tp_blocks.py's forwards read. The optimizer is made
over the placed parameters, so its state is born sharded (the JAX
optimizer_shardings). state_dict / load_state_dict and full_adam_state /
shard_adam_state move between the placed model and the single-device
layout (every model rank takes part): checkpoints hold the full tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.swin import _mmf
from .mesh import TensorParallelMesh, _flat

# -- the placement table -------------------------------------------------------


def _names(name: str) -> List[str]:
    return name.split(".")


def megatron_dim(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """The torch dim `_megatron_spec` shards over the model axis, None for
    replicated."""
    names = _names(name)
    if len(names) < 2 or len(shape) != 2 or names[-1] != "weight":
        return None
    parent = names[-2]
    if parent.endswith(("qkv", "fc1")):  # column: flax kernel columns = weight rows
        return 0 if shape[0] % n_model == 0 else None
    is_attn_proj = parent == "attn_proj" or (
        parent == "proj" and len(names) >= 3 and names[-3].endswith("attn"))
    if parent.endswith("fc2") or is_attn_proj:  # row: flax kernel rows = weight columns
        return 1 if shape[1] % n_model == 0 else None
    return None


def _flax_dims(name: str, shape: Sequence[int]) -> List[int]:
    """The torch dim of each flax axis: a kernel (spatial..., in, out) is a
    weight (out, in, spatial...); other leaves keep their layout."""
    if _names(name)[-1] == "weight" and len(shape) >= 2:
        return list(range(2, len(shape))) + [1, 0]
    return list(range(len(shape)))


def fsdp_dim(name: str, shape: Sequence[int], n_model: int, min_size: int = 1024) -> Optional[int]:
    """The torch dim `_fsdp_spec` shards: the largest flax axis the model
    axis divides, for a parameter of at least min_size elements."""
    size = 1
    for s in shape:
        size *= s
    if len(shape) == 0 or size < min_size:
        return None
    dims = _flax_dims(name, shape)
    for d in sorted(range(len(shape)), key=lambda d: shape[dims[d]], reverse=True):
        s = shape[dims[d]]
        if s % n_model == 0 and s >= n_model:
            return dims[d]
    return None


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter's row of the table: the dim it is sharded over (None:
    replicated) and, for a replicated parameter used as a slice, the dim
    along which each rank reads its slice; by_heads: the part is by heads
    in each of q, k, v (a qkv weight or bias whose heads the model axis
    divides), else one contiguous 1/n block."""

    shard: Optional[int] = None
    slice: Optional[int] = None
    by_heads: bool = False


def param_specs(named_shapes, n_model: int, rule: str = "megatron",
                fsdp_min_size: int = 1024,
                heads: Optional[Mapping[str, int]] = None) -> Dict[str, Spec]:
    """The placement table (transformer_param_specs over port names):
    {name: Spec} for `named_shapes` ((name, tensor or shape) pairs, e.g. a
    model's named_parameters()). heads: {attention module name: head count};
    a sharded qkv whose heads n_model does not divide takes the head split
    (contiguous parts, its tables and tau whole); a qkv without an entry is
    split by heads."""
    shapes = {k: tuple(v.shape if torch.is_tensor(v) else v) for k, v in named_shapes}
    if rule == "fsdp":
        return {k: Spec(fsdp_dim(k, s, n_model, fsdp_min_size)) for k, s in shapes.items()}
    if rule != "megatron":
        raise ValueError(f"unknown param sharding rule: {rule!r}")
    heads = heads or {}
    out = {k: Spec(megatron_dim(k, s, n_model)) for k, s in shapes.items()}
    for k in shapes:
        parent, _, leaf = k.rpartition(".")
        if leaf == "weight" and parent.endswith(".qkv") and out[k].shard == 0:
            h = heads.get(parent[:-len(".qkv")])
            out[k] = Spec(0, by_heads=h is None or h % n_model == 0)
    for k in shapes:
        parent, _, leaf = k.rpartition(".")
        col = out.get(parent + ".weight", Spec())
        qkv = out.get(parent + ".qkv.weight", Spec())
        if leaf == "bias" and col.shard == 0:
            out[k] = Spec(slice=0, by_heads=col.by_heads)  # a column-parallel layer's bias
        elif leaf in ("relative_position_bias_table", "tau") and qkv.shard == 0 and \
                qkv.by_heads:
            out[k] = Spec(slice=1 if leaf == "relative_position_bias_table" else 0)
    return out


# -- placements ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """A placed parameter's part: "shard" (this rank holds its part of dim)
    or "slice" (held whole, this rank reads its part of dim). size: the
    full length along dim; thirds: the part is by heads in each of q, k, v
    (a qkv weight or bias split by heads), else one contiguous 1/n block
    (every other layer, and a head-split qkv)."""

    kind: str
    dim: int
    size: int
    thirds: bool
    mesh: TensorParallelMesh

    @property
    def n(self) -> int:
        return self.mesh.n_model

    def take(self, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Model rank `rank`'s part (default this rank's) of the full tensor t."""
        r = self.mesh.model.rank if rank is None else rank
        if not self.thirds:
            per = self.size // self.n
            return t.narrow(self.dim, r * per, per)
        per = self.size // 3 // self.n
        t3 = t.unflatten(self.dim, (3, self.size // 3)).narrow(self.dim + 1, r * per, per)
        return t3.flatten(self.dim, self.dim + 1)

    def index(self, rank: int, device) -> torch.Tensor:
        """Model rank `rank`'s positions along dim."""
        return dataclasses.replace(self, dim=0).take(torch.arange(self.size, device=device), rank)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The full tensor from every model rank's part (a collective)."""
        parts = [torch.empty_like(part) for _ in range(self.n)]
        dist.all_gather(parts, part.detach().contiguous(), group=self.mesh.model.group)
        shape = list(part.shape)
        shape[self.dim] = self.size
        full = part.new_empty(shape)
        for r, p in enumerate(parts):
            full.index_copy_(self.dim, self.index(r, part.device), p)
        return full


def placement(p) -> Optional[Placement]:
    return getattr(p, "tp", None)


def mesh_of(module) -> Optional[TensorParallelMesh]:
    """The mesh of a module placed by shard_model, else None."""
    return getattr(module, "tp_mesh", None)


def _heads(block) -> int:
    for m in (block, block.attn):
        for attr in ("heads", "num_heads"):
            if hasattr(m, attr):
                return int(getattr(m, attr))
    raise ValueError(f"{type(block).__name__} has no head count")


def _attn_heads(model: torch.nn.Module) -> Dict[str, int]:
    """{attention module name: head count} of every block with a qkv."""
    out = {}
    for name, block in model.named_modules():
        attn = getattr(block, "attn", None)
        if attn is not None and hasattr(attn, "qkv"):
            out[f"{name}.attn" if name else "attn"] = _heads(block)
    return out


def shard_model(model: torch.nn.Module, mesh: TensorParallelMesh) -> torch.nn.Module:
    """Place `model` (on its device, before its optimizer is made) by the
    megatron rule over the mesh's model axis, in place; returns it. A block
    whose qkv the rule shards is split by heads where the model axis
    divides its heads, else it takes the head split (see the module doc).
    On a card it turns cuDNN's deterministic mode on for the process."""
    if mesh.device.type == "cuda":
        # the model peers' replicas take bit-equal gradients only from
        # deterministic kernels: cuDNN's default convolution backward is not
        # (the Cnn14, HeAR's patch embed, the EfficientNet)
        torch.backends.cudnn.deterministic = True
    specs = param_specs(model.named_parameters(), mesh.n_model, "megatron",
                        heads=_attn_heads(model))
    for name, p in model.named_parameters():
        sp = specs[name]
        dim = sp.shard if sp.shard is not None else sp.slice
        if dim is None:
            continue
        pl = Placement("shard" if sp.shard is not None else "slice", dim, p.shape[dim],
                       sp.by_heads, mesh)
        if pl.kind == "shard":
            p.data = pl.take(p.data).contiguous()
        p.tp = pl
    for m in model.modules():
        m.tp_mesh = mesh
    return model


# -- the operators -------------------------------------------------------------


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over the model axis backward: the input
    of a column-parallel layer, whose every rank's share of the gradient is
    summed there."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """All-reduce over the model axis forward, identity backward: the output
    of a row-parallel layer (every rank then holds the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather of the last dim over the model axis forward (the ranks'
    parts in rank order), the rank's part of the cotangent backward: the
    input of a computation that every model rank runs whole and alike, so
    that its cotangent is the same on every rank (Megatron's gather from
    the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rank, ctx.width = rank, x.shape[-1]
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """The rank's contiguous 1/n part of the last dim forward, the
    all-gather of the parts' cotangents backward: the whole activations of
    a computation every model rank runs alike, on their way into a
    row-parallel layer (Megatron's scatter to the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.n = group, n
        width = x.shape[-1] // n
        return x.narrow(-1, rank * width, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, -1), None, None, None


def copy(x: torch.Tensor, mesh: TensorParallelMesh) -> torch.Tensor:
    return _Copy.apply(x, mesh.model.group)


def reduce(x: torch.Tensor, mesh: TensorParallelMesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh.model.group)


def gather(x: torch.Tensor, mesh: TensorParallelMesh) -> torch.Tensor:
    """Every model rank's x concatenated along the last dim (see _Gather)."""
    return _Gather.apply(x, mesh.model.group, mesh.model.rank, mesh.n_model)


def split(x: torch.Tensor, mesh: TensorParallelMesh) -> torch.Tensor:
    """This model rank's contiguous part of x's last dim (see _Split)."""
    return _Split.apply(x, mesh.model.group, mesh.model.rank, mesh.n_model)


def sharded(lin: torch.nn.Module) -> bool:
    """Whether a Linear's weight is split over the model axis."""
    pl = placement(lin.weight)
    return pl is not None and pl.kind == "shard"


def head_split(attn: torch.nn.Module) -> bool:
    """Whether an attention's qkv takes the head split: sharded over the
    model axis in contiguous rows, the heads not divided (module doc)."""
    pl = placement(attn.qkv.weight)
    return pl is not None and pl.kind == "shard" and not pl.thirds


def local(p: torch.Tensor) -> torch.Tensor:
    """The part of a parameter this rank computes with: its shard, its slice,
    or the whole tensor."""
    pl = placement(p)
    return pl.take(p) if pl is not None and pl.kind == "slice" else p


def column_in(x: torch.Tensor, lin: torch.nn.Module) -> torch.Tensor:
    """x on its way into a column-parallel layer: `copy` where lin is
    sharded (x itself elsewhere)."""
    return copy(x, placement(lin.weight).mesh) if sharded(lin) else x


def column(x: torch.Tensor, lin: torch.nn.Module, mm_dtype: torch.dtype,
           weight: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's output columns of a column-parallel Linear (the whole
    output where lin is replicated): float32, operands in mm_dtype. x has
    passed column_in. weight / bias: stand-ins for the rank's parts (a
    scaled qkv)."""
    w = lin.weight if weight is None else weight
    b = local(lin.bias) if bias is None and lin.bias is not None else bias
    y = _mmf(x, mm_dtype) @ _mmf(w, mm_dtype).T
    return y if b is None else y + b


def row(x: torch.Tensor, lin: torch.nn.Module, mm_dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel Linear on this rank's input columns: the partial
    product summed over the model axis, then the bias, float32."""
    y = _mmf(x, mm_dtype) @ _mmf(lin.weight, mm_dtype).T
    if sharded(lin):
        y = reduce(y, placement(lin.weight).mesh)
    return y if lin.bias is None else y + lin.bias


# -- gradients -----------------------------------------------------------------


@torch.no_grad()
def reduce_slices(params: Sequence[torch.Tensor],
                  grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> List:
    """Sum over the model axis the gradients of the parameters used as a
    slice (one flat all-reduce); grads default to the parameters' .grad,
    which then take the sums. Returns the gradients."""
    own = grads is None
    gs = [p.grad for p in params] if own else list(grads)
    idx = [i for i, p in enumerate(params)
           if placement(p) is not None and placement(p).kind == "slice"]
    if not idx:
        return gs
    for i in idx:
        if gs[i] is None:
            gs[i] = torch.zeros_like(params[i])
    buf = _flat([gs[i] for i in idx])
    dist.all_reduce(buf, group=placement(params[idx[0]]).mesh.model.group)
    o = 0
    for i in idx:
        gs[i] = buf[o:o + gs[i].numel()].view_as(gs[i])
        o += gs[i].numel()
        if own:
            params[i].grad = gs[i]
    return gs


def sq_sum(tensors: Sequence[torch.Tensor], params: Sequence[torch.Tensor]):
    """The sum of squares of the full-model tensors `tensors` (one a
    parameter of `params`, in their placement: a parameter, or its
    gradient after reduce_slices): the whole tensors' plus the shards' and
    slices' parts summed over the model axis (`reduce`, so the gradient of
    each part stays on its rank)."""
    whole, part, mesh = [], [], None
    for t, p in zip(tensors, params):
        pl = placement(p)
        if pl is None:
            whole.append((t * t).sum())
        else:
            mesh = pl.mesh
            t = pl.take(t) if pl.kind == "slice" else t
            part.append((t * t).sum())
    total = sum(whole) if whole else torch.zeros((), device=params[0].device)
    if part:
        total = total + reduce(torch.stack(part).sum(), mesh)
    return total


# -- the single-device layout --------------------------------------------------


def _placements(model: torch.nn.Module) -> Dict[str, Placement]:
    return {k: placement(p) for k, p in model.named_parameters()
            if placement(p) is not None and placement(p).kind == "shard"}


def state_dict(model: torch.nn.Module) -> dict:
    """The model's single-device state_dict (sharded parameters gathered;
    every model rank takes part); model.state_dict() for an unplaced model."""
    sd = model.state_dict()
    pls = _placements(model) if mesh_of(model) is not None else {}
    return {k: (pls[k].gather(v) if k in pls else v) for k, v in sd.items()}


def load_state_dict(model: torch.nn.Module, sd: dict) -> None:
    """Load a single-device state_dict into a placed (or unplaced) model:
    each sharded parameter takes this rank's part (the JAX place_like)."""
    pls = _placements(model) if mesh_of(model) is not None else {}
    model.load_state_dict({k: (pls[k].take(torch.as_tensor(v)) if k in pls else v)
                           for k, v in sd.items()})


def _adam_map(params: Sequence[torch.Tensor], adam: dict, fn) -> dict:
    out = {"state": {}, "param_groups": adam["param_groups"]}
    for k, st in adam["state"].items():
        pl = placement(params[int(k)])
        sharded_p = pl is not None and pl.kind == "shard"
        out["state"][k] = {q: (fn(pl, v) if sharded_p and torch.is_tensor(v) and v.dim() else v)
                           for q, v in st.items()}
    return out


def full_adam_state(params: Sequence[torch.Tensor], adam: dict) -> dict:
    """A torch.optim.Adam state_dict over `params` with the sharded
    parameters' moments gathered to full size (every model rank takes part)."""
    return _adam_map(params, adam, lambda pl, v: pl.gather(v).cpu())


def shard_adam_state(params: Sequence[torch.Tensor], adam: dict) -> dict:
    """full_adam_state's inverse: this rank's parts of the full moments."""
    return _adam_map(params, adam, lambda pl, v: pl.take(v).clone())

"""Data parallelism and the dp x tp mesh over torch.distributed —
counterpart of heart_murmur_detection_tpu/parallel/mesh.py (`dp_axis` :39,
`data_parallel_mesh` :51, `mesh_2d` :58, `param_sharding_axis` :107,
`mesh_from_cli` :198, `shard_params_and_opt` :219, `shard_batch` :230,
`place_like` :244).

The JAX package has one controller and N devices; the port has one process
a rank (PyTorch's own model), and every trainer runs inside every rank. A
DataParallelMesh describes the initialised process group of the rank it
lives in: the 1-D data axis of the JAX package's pure data parallelism.

The trainers call functions, not a module's forward, so neither DDP's
reducer nor FSDP's module hooks see their steps. Gradients are reduced by
hand instead, in one flat buffer in parameter order, with one collective a
step, as the JAX psum is:
- each rank runs its contiguous rows [r b / n, (r + 1) b / n) of every
  global batch (shard_rows; the layout of the JAX shard_batch);
- after backward each rank holds its share of the gradient, and the shares
  sum over ranks to the single-device gradient; all_reduce_grads (DP) or
  ZeroShard.reduce_grads (ZeRO-3) completes the step;
- a loss that couples the whole batch (COLA's in-batch negatives) gathers
  every rank's rows with gather_rows, whose backward keeps only the rank's
  own rows of the cotangent (an all_gather whose backward sums the
  cotangents over ranks would give n times the gradient);
- BatchNorm moments are the global batch's (sync_moments: the JAX
  bn_train's ex2 - bm^2, one all_reduce_mean_autograd a BatchNorm, whose
  backward averages the moments' cotangents, so dx sees every rank's path).

ZeRO-3 (param_sharding="fsdp" on the 1-D mesh, the JAX
shard_params_and_opt over the data axis): ZeroShard keeps the trainable
parameters and the optimizer's state as one flat 1/n shard a rank; the
whole model is gathered at use, at the start of a step, and gradients are
reduce-scattered into their owner's shard.

The tensor axis (mesh_2d :58, `param_sharding_axis` :107): a
TensorParallelMesh is the JAX 2-D ('data', 'model') mesh, devices reshaped
row-major to (n_data, n_model), so rank r has data index r // n_model and
model index r % n_model (model peers are consecutive ranks). It carries two
DataParallelMesh views, one over the rank's data-axis group and one over its
model-axis group. Every collective that couples rows (local_rows,
shard_rows, gather_rows, sync_moments, all_reduce_grads, all_reduce_sum) and
rank_generator take the data view, since model peers hold the same rows;
gather_objects, broadcast_value and the barrier take the whole world.
Megatron placement and its forward live in parallel/tensor.py and
models/tp_blocks.py; param_sharding="fsdp" on the 2-D mesh is ZeRO-3 over
the model axis (ZeroShard sums the gradients over the data axis, then each
model rank keeps its slice).

gloo takes CUDA tensors for every collective used here (all_reduce,
all_gather, reduce_scatter_tensor, broadcast, barrier; PyTorch 2.11 on an
H100 machine), so nothing is staged through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import warnings
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """The 1-D data axis of an initialised process group, seen from one rank."""

    rank: int
    world: int
    group: Any
    backend: str
    device: torch.device

    def barrier(self) -> None:
        dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True)
class TensorParallelMesh:
    """The 2-D ('data', 'model') mesh of an initialised process group, seen
    from one rank (the JAX mesh_2d layout: rank = data index * n_model +
    model index). rank / world / group are the whole world's; `data` is the
    rank's data-axis group (the ranks of its model index, its data index as
    rank) and `model` its model-axis group (its n_model consecutive ranks)."""

    rank: int
    world: int
    group: Any
    backend: str
    device: torch.device
    data: DataParallelMesh
    model: DataParallelMesh

    @property
    def n_data(self) -> int:
        return self.data.world

    @property
    def n_model(self) -> int:
        return self.model.world

    def barrier(self) -> None:
        dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True)
class DataParallelPlan:
    """What mesh_from_cli asks for: n data-parallel ranks, each of tp ranks
    on the tensor axis (n tp ranks in all), over `backend` (None: NCCL on a
    card, gloo on the CPU). parallel.launch turns it into a DataParallelMesh
    (tp = 1) or a TensorParallelMesh in each rank."""

    n: int
    backend: Optional[str] = None
    tp: int = 1

    @property
    def world(self) -> int:
        return self.n * self.tp


def check_mesh(mesh):
    """mesh or None; anything else is a TypeError (a JAX Mesh, say)."""
    if mesh is not None and not isinstance(mesh, (DataParallelMesh, TensorParallelMesh)):
        raise TypeError("mesh must be a parallel.mesh.DataParallelMesh or TensorParallelMesh, "
                        f"got {type(mesh).__name__}")
    return mesh


def is_2d(mesh) -> bool:
    return isinstance(mesh, TensorParallelMesh)


def data_axis(mesh) -> Optional[DataParallelMesh]:
    """The mesh's data axis as a DataParallelMesh (the mesh itself when 1-D;
    None without a mesh): the group every row-coupling collective runs over."""
    return mesh.data if is_2d(mesh) else mesh


def world_axis(mesh) -> Optional[DataParallelMesh]:
    """Every rank of the mesh as one flat data axis (the extractor's rows)."""
    if not is_2d(mesh):
        return mesh
    return DataParallelMesh(mesh.rank, mesh.world, mesh.group, mesh.backend, mesh.device)


def data_size(mesh) -> int:
    """The data axis's length (1 without a mesh)."""
    return 1 if mesh is None else data_axis(mesh).world


def param_sharding_axis(mesh, rule: str) -> str:
    """The mesh axis parameters are sharded over (the JAX function :107):
    "model" on a 2-D mesh; "data" for fsdp on a 1-D mesh (ZeRO-3 over pure
    DP); megatron on a 1-D mesh is a ValueError."""
    if is_2d(mesh):
        return "model"
    if rule == "fsdp":
        return "data"
    raise ValueError("megatron param sharding needs a 'model' mesh axis (got ('data',)); "
                     "use a dp x tp mesh or param_sharding=fsdp")


def check_param_sharding(mesh, param_sharding: Optional[str]) -> Optional[str]:
    """A trainer's param_sharding: without a mesh it does nothing, as in the
    JAX trainers (the CLIs refuse it there: mesh_from_cli); "fsdp" is ZeRO-3
    over the data axis (1-D) or the model axis (2-D); "megatron" needs the
    2-D mesh's model axis."""
    if param_sharding is None or mesh is None:
        return None
    if param_sharding not in ("megatron", "fsdp"):
        raise ValueError(f"unknown param sharding rule: {param_sharding!r}")
    param_sharding_axis(check_mesh(mesh), param_sharding)
    return param_sharding


def dp_axis(mesh) -> Optional[str]:
    """The data-axis name of a 1-D mesh ("data"), None without one or on a
    2-D mesh (the JAX gate of the kernel paths: tensor-sharded parameters
    keep the plain graphs)."""
    return None if check_mesh(mesh) is None or is_2d(mesh) else "data"


def plain_only(mesh, fused_train: Optional[bool], param_sharding: Optional[str]) -> bool:
    """Whether a trainer must run its plain path: under param_sharding or a
    2-D mesh, as the JAX trainers keep their XLA graphs there.
    fused_train=True there is a ValueError, never a silent switch."""
    if param_sharding is None and not is_2d(mesh):
        return False
    if fused_train:
        raise ValueError(
            "fused_train under a mesh needs pure data parallelism (a 1-D mesh, no "
            "param_sharding): ZeRO-3 and the tensor axis run the plain path")
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, local_world: int, device) -> None:
    """NCCL takes one card a rank: more ranks on this node (local_world)
    than its cards is refused here (NCCL itself fails with 'Duplicate GPU
    detected'), never switched."""
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("dist_backend=nccl runs on CUDA devices; use dist_backend=gloo")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(f"NCCL needs one card a rank: {local_world} ranks on this node, "
                             f"{cards} card(s); pass dist_backend=gloo to share a card")
    elif backend != "gloo":
        raise ValueError(f"dist_backend {backend!r}: 'nccl' or 'gloo'")


def local_world(world: int) -> int:
    """The ranks on this node: torchrun's LOCAL_WORLD_SIZE (a multi-node
    group spreads its world over the nodes' cards), else the whole world
    (parallel.launch starts every rank on this node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def init_group(backend: str, rank: int, world: int, init_method: str, device) -> None:
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600), **kw)


def rank_device(device, rank: int) -> torch.device:
    """The rank's device: cuda:<rank mod cards> on a card (gloo ranks share
    cards round robin), the CPU otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def data_parallel_mesh(n: Optional[int] = None, backend: Optional[str] = None,
                       device=None) -> DataParallelMesh:
    """The mesh of this rank. The process group is the one already set up
    (by parallel.launch, or torchrun's environment: RANK, WORLD_SIZE,
    MASTER_ADDR); with none, n = 1 sets up a single-rank group on localhost.
    Raises when the group's world size is not n. device: "cuda" (the
    default) or "cpu"."""
    device = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ and "MASTER_ADDR" in os.environ:
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            backend = backend or default_backend(device)
            check_backend(backend, local_world(world), device)
            dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
            init_group(backend, rank, world, "env://", dev)
        elif n in (None, 1):
            backend = backend or default_backend(device)
            check_backend(backend, 1, device)
            init_group(backend, 0, 1, f"tcp://127.0.0.1:{_free_port()}", rank_device(device, 0))
        else:
            raise RuntimeError(
                f"no process group for a {n}-rank mesh: start the ranks with "
                "parallel.launch.launch (or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and world != n:
        raise ValueError(f"the process group has {world} ranks, the mesh asks for {n}")
    got = dist.get_backend()
    if backend is not None and got != backend:
        raise ValueError(f"the process group runs {got}, the mesh asks for {backend}")
    check_backend(got, local_world(world), device)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DataParallelMesh(rank, world, dist.group.WORLD, got, dev)


def mesh_2d(n_data: int, n_model: int, backend: Optional[str] = None,
            device=None) -> TensorParallelMesh:
    """This rank's (n_data x n_model) mesh over the process group already
    set up (parallel.launch with tp=n_model, or torchrun's environment), as
    the JAX mesh_2d lays out devices: rank r at data index r // n_model and
    model index r % n_model. Every rank makes every subgroup, in the same
    order (torch.distributed.new_group's rule)."""
    flat = data_parallel_mesh(n_data * n_model, backend, device)
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(flat.rank, n_model)
    view = lambda rank, world, group: DataParallelMesh(rank, world, group, flat.backend,
                                                       flat.device)
    return TensorParallelMesh(flat.rank, flat.world, flat.group, flat.backend, flat.device,
                              view(d, n_data, data_groups[m]), view(m, n_model, model_groups[d]))


def mesh_from_cli(cfg: dict) -> Tuple[Optional[DataParallelPlan], Optional[str]]:
    """(plan, param_sharding) from the CLI keys dp / tp / param_sharding /
    dist_backend — the JAX contract: dp=N is 1-D data parallelism; tp=M
    adds the tensor axis (a dp x tp plan, megatron unless param_sharding
    says fsdp, which then shards over the model axis); param_sharding=fsdp
    with dp alone is ZeRO-3 over the data axis; param_sharding without a
    mesh is a config error, not a silent no-op."""
    dp, tp = int(cfg.get("dp", 1)), int(cfg.get("tp", 1))
    param_sharding = cfg.get("param_sharding")
    if tp > 1:
        return DataParallelPlan(dp, cfg.get("dist_backend"), tp), param_sharding or "megatron"
    if dp > 1:
        return DataParallelPlan(dp, cfg.get("dist_backend")), param_sharding
    if param_sharding is not None:
        raise ValueError(
            f"param_sharding={param_sharding!r} requires a device mesh; "
            "set dp=N (ZeRO-3 over data) or dp=N tp=M (tensor axis)"
        )
    return None, None


# -- rows ---------------------------------------------------------------------


def local_rows(b: int, mesh) -> slice:
    """This rank's rows of a global batch of b rows (its data index's)."""
    mesh = data_axis(mesh)
    if b % mesh.world:
        raise ValueError(f"batch of {b} rows not divisible by the data axis ({mesh.world})")
    per = b // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_rows(x, mesh: Optional[DataParallelMesh]):
    """This rank's contiguous rows of a global batch (tensor or array);
    the whole batch without a mesh."""
    return x if mesh is None else x[local_rows(x.shape[0], mesh)]


def _all_gather(x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, 0)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows in rank order; the backward keeps the rank's own rows
    of the cotangent (every rank computes the same loss of the gathered
    batch, and its share of the gradient flows through its own rows)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = local_rows(x.shape[0] * mesh.world, mesh)
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order (the global batch;
    over the data axis)."""
    if mesh is None:
        return x
    mesh = data_axis(mesh)
    if x.requires_grad:
        return _GatherRows.apply(x, mesh)
    return _all_gather(x, mesh)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.group)
        return y / mesh.world

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g / ctx.mesh.world, None


def all_reduce_mean_autograd(x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
    """The mean over the data axis of x; its backward averages the
    cotangents over it (for BatchNorm moments: dx then sees every rank's
    use of them)."""
    return _AllReduceMean.apply(x, data_axis(mesh))


def sync_moments(x: torch.Tensor, dims: Sequence[int], mesh: Optional[DataParallelMesh]):
    """A BatchNorm's batch mean and biased variance over `dims` of x, each
    of x's size along the other axes: this rank's rows' without a mesh; with
    one the global batch's, as the JAX bn_train with axis_name forms them
    (models/htsat_train_fused.py:108-125): bm = mean over ranks of the local
    means, ex2 = mean over ranks of (bv + bm^2), bv = ex2 - bm^2, both in
    one autograd-aware all-reduce. They cross ranks in float64, so that
    ex2 - bm^2 cancels no digits of the float32 moments (one rank gives the
    local values)."""
    dims = tuple(dims)
    bm = x.mean(dims)
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    bv = ((x - bm.view(shape)) ** 2).mean(dims)
    if mesh is None:
        return bm, bv
    bm64 = bm.double()
    m = all_reduce_mean_autograd(torch.stack([bm64, bv.double() + bm64 * bm64]), mesh)
    return m[0].to(x.dtype), (m[1] - m[0] * m[0]).to(x.dtype)


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the data axis (a new tensor)."""
    y = x.detach().clone()
    dist.all_reduce(y, group=data_axis(mesh).group)
    return y


def gather_objects(obj, mesh: Optional[DataParallelMesh]) -> list:
    """Every rank's `obj` (picklable), in rank order."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_value(value: float, mesh: Optional[DataParallelMesh]) -> float:
    """Rank 0's number on every rank (a decision every rank must share)."""
    if mesh is None:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return float(t)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor], mesh,
                     grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> List[torch.Tensor]:
    """Sum the gradient shares over the data axis in one flat buffer, in parameter
    order (a parameter without a gradient contributes zeros). grads: the
    shares (default: each parameter's .grad, which takes the sums).
    Returns the summed gradients."""
    own = grads is None
    gs = [p.grad for p in params] if own else list(grads)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
    if mesh is None:
        return gs
    buf = _flat(gs)
    dist.all_reduce(buf, group=data_axis(mesh).group)
    out, o = [], 0
    for p, g in zip(params, gs):
        v = buf[o:o + g.numel()].view_as(g)
        o += g.numel()
        if own:
            p.grad = v
        out.append(v)
    return out


def rank_generator(seed: int, mesh, device) -> torch.Generator:
    """The generator of a rank's own draws (dropout, DropPath,
    drop-connect): `seed` without a mesh, else a seed folded with the rank's
    data index, as the JAX package folds the shard index into its key (model
    peers draw alike). DP then equals the single-device run only at rate 0,
    as in the JAX package."""
    s = seed if mesh is None else seed * 1_000_003 + data_axis(mesh).rank + 1
    return torch.Generator(device=device).manual_seed(s)


# -- ZeRO-3 -------------------------------------------------------------------


def _quiet(fn, *args, **kw):
    """all_gather_into_tensor / reduce_scatter_tensor warn of a rename in
    newer PyTorch; the calls are the same."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


class ZeroShard:
    """ZeRO-3 for `params` (the trainable parameters, in order) over the
    data axis of a 1-D mesh or the model axis of a 2-D one (JAX
    param_sharding_axis): at rest each rank of that axis keeps one flat
    shard of shard_len elements of their concatenation (zero-padded to n
    shard_len), `shard`, which the optimizer updates (its state is
    shard-sized too); the parameters themselves hold no storage once
    released. gather() all-gathers the shards and points every parameter at
    its slice of the full buffer; reduce_grads() completes the gradients
    into shard.grad; release() frees the full buffer. A new ZeroShard leaves
    the parameters as they were (full) until the first release().

    On the 1-D mesh each rank holds its rows' share of the gradient, and a
    reduce-scatter sums the shares into their owner's shard. On the 2-D
    mesh the model peers ran the same rows: the shares are summed over the
    data axis and each model rank keeps its slice of the sum (a
    reduce-scatter over the model axis would add n_model equal copies)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], mesh):
        self.params = list(params)
        self.mesh = mesh.model if is_2d(mesh) else mesh  # the axis the shards lie on
        self.sum_over = mesh.data if is_2d(mesh) else None
        self.shapes = [p.shape for p in self.params]
        self.numels = [p.numel() for p in self.params]
        self.total = sum(self.numels)
        self.shard_len = -(-self.total // self.mesh.world)
        p0 = self.params[0]
        self.shard = torch.nn.Parameter(torch.empty(self.shard_len, dtype=p0.dtype,
                                                    device=p0.device))
        self.load_params()

    def _own(self, full: torch.Tensor) -> torch.Tensor:
        lo = self.mesh.rank * self.shard_len
        return full[lo:lo + self.shard_len]

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(flat, (0, self.shard_len * self.mesh.world - flat.numel()))

    @torch.no_grad()
    def load_params(self) -> None:
        """The shard from the parameters' current (full) values."""
        self.shard.copy_(self._own(self._pad(_flat([p.detach() for p in self.params]))))

    def gather_flat(self, shard: torch.Tensor) -> torch.Tensor:
        """A shard-sized tensor of every rank, concatenated: (total,)."""
        full = torch.empty(self.shard_len * self.mesh.world, dtype=shard.dtype,
                           device=shard.device)
        _quiet(dist.all_gather_into_tensor, full, shard.detach().contiguous(),
               group=self.mesh.group)
        return full[:self.total]

    @torch.no_grad()
    def gather(self) -> None:
        """Every parameter at full size, a view of the gathered buffer."""
        full, o = self.gather_flat(self.shard), 0
        for p, n, s in zip(self.params, self.numels, self.shapes):
            p.data = full[o:o + n].view(s)
            o += n

    def release(self) -> None:
        """Free the full parameters (they hold no storage until gather())."""
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    @torch.no_grad()
    def reduce_grads(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
        """The summed gradient shares' slice of this rank: shard.grad. grads
        default to the parameters' .grad."""
        gs = [p.grad for p in self.params] if grads is None else list(grads)
        gs = [torch.zeros(s, dtype=self.shard.dtype, device=self.shard.device) if g is None else g
              for g, s in zip(gs, self.shapes)]
        if self.sum_over is not None:
            flat = self._pad(_flat(gs))
            dist.all_reduce(flat, group=self.sum_over.group)
            out = self._own(flat).clone()
        else:
            out = torch.empty_like(self.shard)
            _quiet(dist.reduce_scatter_tensor, out, self._pad(_flat(gs)), group=self.mesh.group)
        self.shard.grad = out
        return out

    def full_state(self, state: dict) -> dict:
        """A torch.optim state_dict over [shard] with its shard-sized
        tensors gathered to full size (every rank takes part)."""
        out = {"state": {}, "param_groups": state["param_groups"]}
        for k, st in state["state"].items():
            out["state"][k] = {q: (self.gather_flat(v).cpu() if torch.is_tensor(v)
                                   and v.shape == self.shard.shape else v)
                               for q, v in st.items()}
        return out

    def shard_state(self, state: dict) -> dict:
        """full_state's inverse: this rank's slices of the full-size tensors."""
        out = {"state": {}, "param_groups": state["param_groups"]}
        for k, st in state["state"].items():
            out["state"][k] = {q: (self._own(self._pad(v.reshape(-1))).clone()
                                   if torch.is_tensor(v) and v.numel() == self.total else v)
                               for q, v in st.items()}
        return out


def shard_params_and_opt(params: Sequence[torch.nn.Parameter], mesh, make_opt):
    """ZeRO-3 placement (the JAX shard_params_and_opt :219 with fsdp: over
    the data axis of a 1-D mesh, the model axis of a 2-D one): (ZeroShard
    of params, make_opt([shard]): the optimizer born shard-sized)."""
    zero = ZeroShard(params, mesh)
    return zero, make_opt([zero.shard])


def place_like(target, state):
    """`state` (a restored tree of host tensors) with each tensor on the
    device and dtype of the matching leaf of `target` (the placement the
    run was set up with), as the JAX place_like restores a resumed run's
    layout. Leaves that are not tensors pass through."""
    if isinstance(state, dict):
        return {k: place_like(target.get(k) if isinstance(target, dict) else None, v)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        tl = target if isinstance(target, (list, tuple)) else [None] * len(state)
        return type(state)(place_like(t, v) for t, v in zip(tl, state))
    if torch.is_tensor(state) and torch.is_tensor(target):
        return state.to(device=target.device, dtype=target.dtype)
    return state

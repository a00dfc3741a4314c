"""Named-rule sharding registry: the single place state placement is decided.

The port of ``repro.dist.sharding`` over ``torch.distributed``.  Every
tensor class (weights, batches, decode caches, offload staging buffers,
activations) resolves its placement through a *named rule*, and the model
code never mentions mesh axes.

Three layers, as in the reference:

* **Mesh vocabulary** — :class:`MeshRules` maps a mesh's axis names onto the
  two logical roles: ``dp`` (the data-parallel axes, ``("data",)`` single-pod
  or ``("pod", "data")`` multi-pod, always a tuple so hierarchical DP is one
  spec entry) and ``model`` (the tensor-parallel axis).  A mesh is an
  :class:`~repro_torch.dist.compat.AbstractMesh` (names and sizes only) or
  a named ``DeviceMesh`` over the live process group.

* **Storage rules** — :func:`param_shardings` / :func:`batch_shardings` /
  :func:`cache_shardings` / :func:`offload_stage_shardings` assign a
  :class:`PartitionSpec` to every leaf.  A spec is a tuple with one entry
  per dim: ``None``, an axis name, or a tuple of axis names.  Parameter
  placement goes through the :data:`PARAM_RULES` registry, keyed on the
  leaf's path in the JAX package's parameter tree (the port's per-layer
  leaf ``layers.3.attn.wq`` is a slice of the stacked JAX leaf
  ``layers/attn/wq``; :func:`jax_path` maps one to the other), so each
  port leaf gets exactly the reference's spec with the layer axis dropped.
  Every rule is divisibility-guarded (:func:`_fit_spec`).

* **Activation policy** — :class:`ShardingPolicy` carries the named
  activation specs; :func:`activation_sharding` installs it and
  :func:`constrain` looks a rule up.  PyTorch has no GSPMD: a plain tensor
  is never re-laid-out implicitly, so ``constrain`` leaves plain tensors
  unchanged and only redistributes a ``DTensor``.  The port's model code
  does not call it: under a mesh every rank runs the dense compute of its
  slots replicated over ``model``, and only the decode state is split: the
  paged pool, the per-slot rings and the SSD state's heads
  (``models/kvcache.py`` reads the policy's :class:`PoolShard` and
  :class:`RingShard` and merges the per-shard softmax states,
  ``models/mamba2.py`` its :class:`SSMShard` and gathers the scan's heads,
  through the collectives named here), and the MoE experts
  (``models/moe.py`` reads its :class:`ExpertShard`, each rank computing
  its experts' pairs and all-reducing the fp32 partial sum).

Collectives are explicit: :meth:`ShardingPolicy.all_reduce` runs
``dist.all_reduce`` over one axis's sub-group of the ``DeviceMesh`` and
counts the bytes each call sends (:meth:`ShardingPolicy.collective_bytes`),
the port's counterpart of the reference smoke's HLO wire-byte gate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from contextvars import ContextVar
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from .compat import AbstractMesh, DTensor, Replicate, Shard, mesh_axes

# ---------------------------------------------------------------------------
# Specs and the mesh vocabulary
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (one dim split over several axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# The full mesh-axis vocabulary: ``pod`` (inter-pod hierarchical DP,
# multi-pod only), ``data`` (intra-pod DP), ``model`` (tensor parallel).
MESH_AXES: Tuple[str, ...] = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical axis roles for a (possibly abstract) mesh."""

    axis_names: Tuple[str, ...]
    dp: Tuple[str, ...]      # data-parallel axes (hierarchical on multi-pod)
    model: str               # tensor-parallel axis

    @classmethod
    def for_mesh(cls, mesh) -> "MeshRules":
        names = tuple(mesh_axes(mesh))
        model = "model" if "model" in names else names[-1]
        dp = tuple(a for a in names if a != model)
        return cls(axis_names=names, dp=dp, model=model)

    def dp_size(self, mesh) -> int:
        sizes = mesh_axes(mesh)
        return int(math.prod(sizes[a] for a in self.dp)) if self.dp else 1

    def model_size(self, mesh) -> int:
        return int(mesh_axes(mesh)[self.model])


def _axes_size(entry, mesh) -> int:
    sizes = mesh_axes(mesh)
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(math.prod(sizes[a] for a in axes))


def _fit_spec(spec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Divisibility guard: drop any spec entry whose axes do not evenly
    divide the corresponding dim (rules stay total over shapes/meshes)."""
    entries = [*spec] + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries, strict=True):
        if entry is None:
            out.append(None)
        else:
            out.append(entry if dim % _axes_size(entry, mesh) == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# Parameter storage rules (the registry)
# ---------------------------------------------------------------------------

# Top-level keys of the JAX tree whose children carry a leading
# scan-over-layers dim that storage rules must skip.
STACKED_PREFIXES = ("layers", "blocks", "enc_layers")


@dataclasses.dataclass(frozen=True)
class ParamRule:
    """One named storage rule: ``match`` on the JAX tree path decides
    applicability, ``spec`` produces the (unfitted) spec."""

    name: str
    match: Callable[[Tuple[str, ...], Tuple[int, ...]], bool]
    spec: Callable[[Tuple[str, ...], Tuple[int, ...], MeshRules, Any], PartitionSpec]


def _nspec(ndim: int, at: Dict[int, Any]) -> PartitionSpec:
    """Spec with entries at the given (possibly negative) dims."""
    entries = [None] * ndim
    for pos, axes in at.items():
        entries[pos] = axes
    return P(*entries)


def _rule_head(keys, shape, rules, mesh) -> PartitionSpec:
    # (d_model, padded_vocab): vocab on model, contraction dim unsharded —
    # sharding d would all-reduce the full logits tensor
    return _nspec(len(shape), {-1: rules.model})


def _rule_embed(keys, shape, rules, mesh) -> PartitionSpec:
    # (padded_vocab, d_model): rows on dp (ZeRO-style), d on model
    return _nspec(len(shape), {-2: tuple(rules.dp) or None, -1: rules.model})


def _rule_expert_in(keys, shape, rules, mesh) -> PartitionSpec:
    # (..., E, D, F): experts on model (EP), D on dp (FSDP)
    return _nspec(len(shape), {-3: rules.model, -2: tuple(rules.dp) or None})


def _rule_expert_out(keys, shape, rules, mesh) -> PartitionSpec:
    # (..., E, F, D): experts on model, output D on dp
    return _nspec(len(shape), {-3: rules.model, -1: tuple(rules.dp) or None})


def _auto_spec(keys, shape, rules, mesh) -> PartitionSpec:
    """Fallback: greedy largest-divisible assignment (model first, then dp).

    Skips the leading scan dim for stacked trees.  Breaks size ties toward
    the trailing dim for ``model``, which lands matmul weights in the
    (dp, model) FSDP x TP layout.
    """
    sp = 1 if keys and keys[0] in STACKED_PREFIXES and len(shape) > 1 else 0
    entries: list = [None] * len(shape)
    candidates = sorted(range(sp, len(shape)), key=lambda i: (shape[i], i), reverse=True)
    picked_model = None
    model_size = rules.model_size(mesh)
    for i in candidates:
        if shape[i] > 1 and shape[i] % model_size == 0:
            entries[i] = rules.model
            picked_model = i
            break
    if rules.dp:
        dp_size = rules.dp_size(mesh)
        for i in candidates:
            if i != picked_model and shape[i] > 1 and shape[i] % dp_size == 0:
                entries[i] = tuple(rules.dp)
                break
    return P(*entries)


PARAM_RULES: Tuple[ParamRule, ...] = (
    ParamRule("head",
              lambda keys, shape: keys[-1:] == ("head",) and len(shape) >= 2,
              _rule_head),
    ParamRule("embed",
              lambda keys, shape: keys[-1:] == ("embed",) and len(shape) >= 2,
              _rule_embed),
    ParamRule("expert_ffn_in",
              lambda keys, shape: "experts" in keys and len(shape) >= 3
              and keys[-1] in ("w_gate", "w_up"),
              _rule_expert_in),
    ParamRule("expert_ffn_out",
              lambda keys, shape: "experts" in keys and len(shape) >= 3
              and keys[-1] == "w_down",
              _rule_expert_out),
    ParamRule("auto", lambda keys, shape: len(shape) >= 2, _auto_spec),
)


def resolve_param_rule(keys: Tuple[str, ...], shape: Tuple[int, ...]
                       ) -> Optional[ParamRule]:
    """First registry rule matching this (JAX path, JAX shape); None ->
    replicate."""
    for rule in PARAM_RULES:
        if rule.match(keys, shape):
            return rule
    return None


def _resolve_param_spec(keys, shape, rules: MeshRules, mesh) -> PartitionSpec:
    rule = resolve_param_rule(keys, shape)
    if rule is None:
        return P()
    return _fit_spec(rule.spec(keys, shape, rules, mesh), shape, mesh)


def jax_path(name: str, cfg) -> Tuple[Tuple[str, ...], bool]:
    """The JAX tree path of the port's parameter ``name`` and whether the
    JAX leaf stacks it on a leading layer axis: ``layers.<i>.*`` is
    ``layers/*`` (a hybrid's ``blocks/l<i mod n>/*``, or ``tail/t<j>/*``
    past the last whole super-block), ``enc_layers.<i>.*`` is
    ``enc_layers/*``, every other leaf its own path."""
    from ..weights import jax_stacked

    parts = name.split(".")
    stacked = jax_stacked(name, cfg)
    if parts[0] == "layers" and cfg.family == "hybrid":
        n = len(cfg.hybrid.pattern)
        i = int(parts[1])
        head = ("blocks", f"l{i % n}") if stacked else ("tail", f"t{i - cfg.n_layers // n * n}")
        return head + tuple(parts[2:]), stacked
    if stacked:
        return (parts[0],) + tuple(parts[2:]), True
    return tuple(parts), False


def param_spec(name: str, shape: Tuple[int, ...], mesh, cfg) -> PartitionSpec:
    """The spec of the port's parameter ``name`` of ``shape``: the
    reference's spec for the JAX leaf holding it, without the layer axis
    (which no rule shards) when the JAX leaf is stacked."""
    keys, stacked = jax_path(name, cfg)
    rules = MeshRules.for_mesh(mesh)
    if not stacked:
        return _resolve_param_spec(keys, tuple(shape), rules, mesh)
    spec = _resolve_param_spec(keys, (1,) + tuple(shape), rules, mesh)
    if not spec:
        return spec
    if spec[0] is not None:
        raise AssertionError(f"{name}: a rule sharded the layer axis ({spec})")
    return P(*spec[1:])


def param_shardings(params, mesh, cfg=None) -> Dict[str, PartitionSpec]:
    """``{name: spec}`` for a parameter set: an ``nn.Module`` (its config
    read from ``.cfg``) or a ``{name: tensor}`` mapping with ``cfg`` given.
    Leaves may live on any device, the meta device included."""
    if isinstance(params, torch.nn.Module):
        cfg = params.cfg if cfg is None else cfg
        params = dict(params.named_parameters())
    if cfg is None:
        raise ValueError("param_shardings of a mapping needs the model's cfg")
    return {name: param_spec(name, tuple(t.shape), mesh, cfg) for name, t in params.items()}


# ---------------------------------------------------------------------------
# Batch / cache storage rules
# ---------------------------------------------------------------------------


def _map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict (the port's trees are dicts)."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def batch_shardings(batch, mesh):
    """Leading (global-batch) dim on the full dp tuple; replicated when the
    batch does not divide (e.g. the B=1 long-context cell)."""
    rules = MeshRules.for_mesh(mesh)
    dp_size = rules.dp_size(mesh)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if rules.dp and shape and shape[0] % dp_size == 0:
            return P(tuple(rules.dp), *([None] * (len(shape) - 1)))
        return P()

    return _map_tree(assign, batch)


# ring leaf keys; dims are indexed from the right so stacked (leading layer
# dim) and unstacked leaves share one rule
_CACHE_KV_KEYS = frozenset({"k", "v", "xk", "xv"})
# paged-pool leaf keys: (..., n_pages, page_size, H, D) shared across slots
POOL_KEYS = frozenset({"kp", "vp"})


def _pool_entries(shape, rules: MeshRules, mesh, scratch: int) -> list:
    """The pool rule: within-page lane dim on ``model`` first, then heads,
    then pages.  ``scratch`` pages at the end of the page axis are not
    allocatable (the port's pool keeps one: writes through unmapped table
    entries land there), so the page rule divides the allocatable count,
    as the reference's pool, which has none."""
    nd = len(shape)
    entries: list = [None] * nd
    m = _axes_size(rules.model, mesh)
    for dim, size in ((nd - 3, shape[-3]), (nd - 2, shape[-2]), (nd - 4, shape[-4] - scratch)):
        if size % m == 0:
            entries[dim] = rules.model
            break
    return entries


def cache_shardings(cache, mesh, *, scratch_pages: int = 1):
    """Decode-state placement.

    kv rings (..., B, T, H, D): batch on dp; heads on model when the head
    count divides, else the time dim.  Paged pools (..., n_pages + 1,
    page_size, H, D) have no slot axis — every slot's page table indexes one
    shared pool — so the pool stays *replicated over dp* and shards its
    within-page lane dim on model (heads, then pages, as fallbacks: the
    paged-attention kernel reads per-(page, head) blocks through the table,
    which a head-sharded pool serves per head group and a page-sharded one
    only by gathering the pool).  Page tables (..., n_slots, max_pages)
    follow the slot batch onto dp.  SSM states shard their head dim, conv
    tails and RG-LRU states their channel dim.  ``scratch_pages``: pages at
    the end of the pool's page axis that no table maps (the port's pool
    has one).
    """
    rules = MeshRules.for_mesh(mesh)
    dp = tuple(rules.dp) or None

    def assign(path, leaf):
        key = path[-1] if path else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries: list = [None] * nd

        def put(dim: int, axes) -> bool:
            i = nd + dim if dim < 0 else dim
            if 0 <= i < nd and axes is not None and shape[i] % _axes_size(axes, mesh) == 0:
                entries[i] = axes
                return True
            return False

        if key in POOL_KEYS and nd >= 4:         # (..., Np, ps, H, D) shared pool
            entries = _pool_entries(shape, rules, mesh, scratch_pages)
        elif key == "page_table" and nd >= 2:    # (..., n_slots, max_pages)
            put(-2, dp)
        elif key in _CACHE_KV_KEYS and nd >= 4:  # (..., B, T, H, D)
            put(-4, dp)
            put(-2, rules.model) or put(-3, rules.model)
        elif key == "ssm" and nd >= 4:           # (..., B, H, P, N)
            put(-4, dp)
            put(-3, rules.model)
        elif key == "conv" and nd >= 3:          # (..., B, K-1, C)
            put(-3, dp)
            put(-1, rules.model)
        elif key == "h" and nd >= 2:             # (..., B, W) rg-lru state
            put(-2, dp)
            put(-1, rules.model)
        elif key == "positions" and nd >= 2:     # (..., B, T)
            put(-2, dp)
        return P(*entries)

    return _map_tree(assign, cache)


def serving_cache_specs(cache, mesh, *, batch_shardable: bool):
    """Where a sharded scheduler keeps each leaf of its cache (paged or
    rings).  The leaves the model axis splits follow :func:`cache_shardings`:
    the pool (lanes, then heads, on ``model``; replicated over dp), the ring
    ``k``/``v`` (kv heads on ``model`` when they divide, else the ring axis
    T) with ``positions`` following their T split (the reference leaves
    ``positions`` whole and lets GSPMD gather it; here each rank keeps the
    positions of its own lanes), and the SSD state ``ssm`` (heads on
    ``model``).  Every per-slot leaf has its slot axis on dp when the slots
    divide (``batch_shardable``), else replicated.  The conv tails and the
    RG-LRU state ``h`` are on nothing but dp: each rank runs its slots'
    dense compute, the conv and the RG-LRU scan included, replicated over
    ``model`` (the reference splits their channel axis on ``model``, which
    for the SSD conv would cut across the ``[x, B, C]`` boundaries of its
    input)."""
    rules = MeshRules.for_mesh(mesh)
    placed = cache_shardings({k: v for k, v in cache.items()
                              if k in POOL_KEYS or k in ("k", "v", "ssm")}, mesh)
    dp = tuple(rules.dp) if batch_shardable and rules.dp else None
    out = {}
    for key, leaf in cache.items():
        if key in POOL_KEYS:
            out[key] = placed[key]
            continue
        entries: list = [None] * leaf.ndim
        entries[0 if key in ("page_table", "length") else 1] = dp
        if key in ("k", "v", "ssm"):    # (L, B, T, Hkv, D) / (L, B, H, P, N)
            entries[2:] = placed[key][2:]
        elif key == "positions":         # (L, B, T): the rings' T split
            entries[2] = placed["k"][2]
        out[key] = P(*entries)
    return out


def offload_stage_shardings(stage, mesh):
    """Placement for KV offload staging buffers ``(..., n_chunk_pages,
    page_size, H, D)``: the pool's own fallback order (lane dim on
    ``model`` first, then heads) so each shard moves its own pool slice;
    the gathered-page dim and everything else stay replicated."""
    rules = MeshRules.for_mesh(mesh)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries: list = [None] * nd
        if path and path[-1] in POOL_KEYS and nd >= 4:
            msize = _axes_size(rules.model, mesh)
            for dim in (nd - 3, nd - 2):    # (..., n, ps, H, D): lane, heads
                if shape[dim] % msize == 0:
                    entries[dim] = rules.model
                    break
        return P(*entries)

    return _map_tree(assign, stage)


# ---------------------------------------------------------------------------
# Specs on a live mesh: placements and this rank's slice
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec, mesh) -> list:
    """DTensor placements (one per mesh axis, in axis order) for ``spec``:
    ``Shard(d)`` on every axis that dim ``d``'s entry names, ``Replicate()``
    on the others.  DTensor nests the shards of one dim in mesh-axis order,
    so a dim split over several axes must name them in that order (major
    first, as every rule does: ``("pod", "data")``); another order raises."""
    names = tuple(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"dim {dim} of {spec} names {axes} out of the mesh's axis order "
                             f"{names}: DTensor cannot nest its shards so")
        for axis in axes:
            out[names.index(axis)] = Shard(dim)
    return out


def _coordinate(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh_axes(mesh), coord))


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the global tensor ``t`` under ``spec`` (a
    contiguous copy), from the rank's mesh coordinates: each sharded dim is
    cut into ``prod(axis sizes)`` equal blocks and the block at the
    coordinates' major-first index kept — what
    ``distribute_tensor(t, mesh, to_placements(spec, mesh)).to_local()``
    holds, for dims the spec divides."""
    sizes, coord = mesh_axes(mesh), _coordinate(mesh)
    out = t
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {axes}")
        step = t.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.contiguous()


# ---------------------------------------------------------------------------
# The paged pool on a live mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolShard:
    """Which slice of the paged pool this rank holds: ``mode`` "lane"
    (lanes ``[index * page_size / count, (index + 1) * page_size / count)``
    of every page), "head" (kv heads ``[index * n_kv_heads / count, ...)``)
    or "replicated"; ``page_size`` and ``n_kv_heads`` are the global ones."""

    mode: str
    index: int
    count: int
    page_size: int
    n_kv_heads: int

    @classmethod
    def for_pool(cls, spec, pool_shape: Tuple[int, ...], mesh) -> "PoolShard":
        """The layout ``cache_shardings`` gave a pool of global shape
        ``(..., n_pages + 1, page_size, Hkv, D)``; a page-sharded pool is
        refused (the per-shard kernel reads pages through the table, which
        only a gather of the pool could serve)."""
        rules = MeshRules.for_mesh(mesh)
        nd = len(pool_shape)
        count = rules.model_size(mesh)
        index = _model_index(mesh)
        ps, hkv = pool_shape[-3], pool_shape[-2]
        if count == 1:          # every rank holds the whole pool
            return cls("replicated", 0, 1, ps, hkv)
        if spec[nd - 3] is not None:
            return cls("lane", index, count, ps, hkv)
        if spec[nd - 2] is not None:
            return cls("head", index, count, ps, hkv)
        if spec[nd - 4] is not None:
            raise NotImplementedError(
                "a page-sharded pool (page size and kv heads both indivisible by the "
                "model axis) is not ported yet: the reference lets GSPMD gather it")
        return cls("replicated", 0, 1, ps, hkv)

    @property
    def split(self) -> bool:
        return self.mode in ("lane", "head")

    def lanes(self) -> Tuple[int, int]:
        w = self.page_size // self.count if self.mode == "lane" else self.page_size
        lo = self.index * w if self.mode == "lane" else 0
        return lo, lo + w

    def heads(self) -> Tuple[int, int]:
        w = self.n_kv_heads // self.count if self.mode == "head" else self.n_kv_heads
        lo = self.index * w if self.mode == "head" else 0
        return lo, lo + w


def _model_index(mesh) -> int:
    rules = MeshRules.for_mesh(mesh)
    return _coordinate(mesh)[rules.model] if not isinstance(mesh, AbstractMesh) else 0


@dataclasses.dataclass(frozen=True)
class RingShard:
    """Which slice of the per-slot rings (``k``/``v`` (L, B, T, Hkv, D),
    ``positions`` (L, B, T)) this rank holds: ``mode`` "head" (kv heads
    ``[index * n_kv_heads / count, ...)``), "seq" (ring lanes ``[index * T /
    count, ...)``) or "replicated"; ``T`` and ``n_kv_heads`` are the global
    ones.  A T-split ring keeps :attr:`scratch` extra lanes past its own:
    a token whose lane another shard holds is written there (no host sync
    filters it out) and never read."""

    mode: str
    index: int
    count: int
    T: int
    n_kv_heads: int

    @classmethod
    def for_ring(cls, spec, ring_shape: Tuple[int, ...], mesh) -> "RingShard":
        """The layout :func:`serving_cache_specs` gave a ring of global
        shape ``(L, B, T, Hkv, D)``."""
        T, hkv = ring_shape[-3], ring_shape[-2]
        count = MeshRules.for_mesh(mesh).model_size(mesh)
        if count > 1 and spec[-2] is not None:
            return cls("head", _model_index(mesh), count, T, hkv)
        if count > 1 and spec[-3] is not None:
            return cls("seq", _model_index(mesh), count, T, hkv)
        return cls("replicated", 0, 1, T, hkv)

    @property
    def split(self) -> bool:
        return self.mode in ("head", "seq")

    @property
    def scratch(self) -> int:
        return 1 if self.mode == "seq" else 0

    def lanes(self) -> Tuple[int, int]:
        w = self.T // self.count if self.mode == "seq" else self.T
        lo = self.index * w if self.mode == "seq" else 0
        return lo, lo + w

    def heads(self) -> Tuple[int, int]:
        w = self.n_kv_heads // self.count if self.mode == "head" else self.n_kv_heads
        lo = self.index * w if self.mode == "head" else 0
        return lo, lo + w


@dataclasses.dataclass(frozen=True)
class SSMShard:
    """Which heads of the SSD state ``ssm`` (L, B, H, P, N) this rank
    holds: ``mode`` "head" (heads ``[index * n_heads / count, ...)``) or
    "replicated"; ``n_heads`` is the global H."""

    mode: str
    index: int
    count: int
    n_heads: int

    @classmethod
    def for_state(cls, spec, state_shape: Tuple[int, ...], mesh) -> "SSMShard":
        """The layout :func:`serving_cache_specs` gave an ``ssm`` leaf of
        global shape ``(L, B, H, P, N)``."""
        count = MeshRules.for_mesh(mesh).model_size(mesh)
        if count > 1 and spec[-3] is not None:
            return cls("head", _model_index(mesh), count, state_shape[-3])
        return cls("replicated", 0, 1, state_shape[-3])

    @property
    def split(self) -> bool:
        return self.mode == "head"

    def heads(self) -> Tuple[int, int]:
        w = self.n_heads // self.count if self.split else self.n_heads
        lo = self.index * w if self.split else 0
        return lo, lo + w


def expert_serving_spec(shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Where a serving rank keeps an expert leaf (``w_gate``/``w_up`` (E, D,
    F), ``w_down`` (E, F, D), or any (..., E, ·, ·) stack): experts on
    ``model``, each expert whole, replicated over ``data``.  This is the
    reference's storage rule (``_rule_expert_in`` / ``_rule_expert_out``)
    with its ``dp`` entry dropped, divisibility-guarded the same way: where
    E does not divide over ``model`` every rank keeps every expert.

    Divergence: the reference also splits each expert's D over ``data``
    (FSDP), and its stationary decode then gathers the step's tokens over
    ``dp``, psums the gate/up partials over ``dp`` and all-gathers the down
    output over ``dp`` (``src/repro/models/moe.py:127-137``).  Here a chunk
    step or a ring prefill belongs to one data group, so that split would
    put three collectives on ``data`` inside every MoE layer of a step the
    other data group does not run; it waits for ROADMAP 1.8c-ii, and costs
    memory only where ``data`` > 1."""
    rules = MeshRules.for_mesh(mesh)
    return _fit_spec(_nspec(len(shape), {-3: rules.model}), tuple(shape), mesh)


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """Which experts of an MoE layer this rank holds and computes: ``mode``
    "expert" (experts ``[index * n_experts / count, (index + 1) * n_experts
    / count)``, from the rank's ``model`` coordinate) or "replicated" (every
    expert; a size-1 ``model`` axis, or E indivisible by it);
    ``n_experts`` is the global E (:func:`expert_serving_spec`)."""

    mode: str
    index: int
    count: int
    n_experts: int

    @classmethod
    def for_mesh(cls, mesh, n_experts: int) -> "ExpertShard":
        """The shard :func:`expert_serving_spec` gives this rank of
        ``mesh`` (rank 0's of an abstract mesh)."""
        count = MeshRules.for_mesh(mesh).model_size(mesh)
        if count == 1 or expert_serving_spec((n_experts, 1, 1), mesh)[0] is None:
            return cls.whole(n_experts)
        return cls("expert", _model_index(mesh), count, n_experts)

    @classmethod
    def whole(cls, n_experts: int) -> "ExpertShard":
        return cls("replicated", 0, 1, n_experts)

    @property
    def split(self) -> bool:
        return self.mode == "expert"

    @property
    def local(self) -> int:
        """Experts this rank holds."""
        return self.n_experts // self.count

    def experts(self) -> Tuple[int, int]:
        lo = self.index * self.local
        return lo, lo + self.local


# ---------------------------------------------------------------------------
# Activation policy
# ---------------------------------------------------------------------------


class WireCounter:
    """Bytes sent through collectives (each call's payload per rank), the
    number of calls, and the host seconds they took (each timed from the
    moment its operand is ready: a CUDA operand's stream is synchronised
    first, so the time is the collective's, not the queued work's)."""

    def __init__(self):
        self.bytes = 0
        self.calls = 0
        self.seconds = 0.0


_REDUCE_OPS = ("sum", "max")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Named activation-layout rules for one mesh, installed with
    :func:`activation_sharding` and read by :func:`constrain`; on a live
    mesh also the pool layout (:class:`PoolShard`) and the collectives the
    sharded paths run."""

    mesh: Any
    specs: Dict[str, PartitionSpec]
    rules: MeshRules
    batch_shardable: bool = True
    attn_mode: str = "head"              # "head" | "seq"
    decode_stationary: bool = False      # stationary-weights MoE decode
    shard_map_pool: bool = False         # per-shard paged kernel + merge
    pool: Optional[PoolShard] = None     # this rank's slice of the pool
    ring: Optional[RingShard] = None     # ... of the per-slot rings
    ssm: Optional[SSMShard] = None       # ... of the SSD state's heads
    experts: Optional[ExpertShard] = None  # ... of each MoE layer's experts (None: all)
    wire: WireCounter = dataclasses.field(default_factory=WireCounter, compare=False)

    @classmethod
    def default(cls, mesh, *, batch_shardable: bool = True,
                attn_mode: str = "head", decode_stationary: bool = False,
                shard_map_pool: bool = False,
                overrides: Optional[Dict[str, PartitionSpec]] = None,
                pool: Optional[PoolShard] = None, ring: Optional[RingShard] = None,
                ssm: Optional[SSMShard] = None,
                experts: Optional[ExpertShard] = None) -> "ShardingPolicy":
        """The standard rule table.

        ``attn_mode="head"`` shards attention heads on ``model`` (needs the
        head counts to divide); ``"seq"`` falls back to sequence sharding for
        q with replicated kv (GQA/MQA archs whose kv heads don't divide).
        """
        rules = MeshRules.for_mesh(mesh)
        dp = tuple(rules.dp) if (batch_shardable and rules.dp) else None
        mdl = rules.model
        specs: Dict[str, PartitionSpec] = {
            "activation": P(dp, mdl, None),
            "block_in": P(dp, None, None),
            "mlp_hidden": P(dp, None, mdl),
            "logits": P(dp, None, mdl),
            "w_col": P(None, mdl),
            "w_row": P(mdl, None),
            "head_weight": P(None, mdl),
            "ssm_heads": P(dp, None, mdl, None),
            "ssm_dt": P(dp, None, mdl),
            "lru_channels": P(dp, None, mdl),
        }
        if attn_mode == "head":
            specs["q_heads"] = P(dp, None, mdl, None)
            specs["kv_heads"] = P(dp, None, mdl, None)
            specs["attn_out"] = P(dp, None, mdl, None)
        else:
            specs["q_heads"] = P(dp, mdl, None, None)
            specs["kv_heads"] = P(dp, None, None, None)
            specs["attn_out"] = P(dp, mdl, None, None)
        if overrides:
            specs.update(overrides)
        return cls(mesh=mesh, specs=specs, rules=rules,
                   batch_shardable=batch_shardable, attn_mode=attn_mode,
                   decode_stationary=decode_stationary,
                   shard_map_pool=shard_map_pool, pool=pool, ring=ring, ssm=ssm,
                   experts=experts)

    def whole_state(self) -> "ShardingPolicy":
        """This policy with no decode-state shard (pool, rings, SSD state):
        a from-scratch prefill into a fresh whole ring runs under it, its
        MoE layers still on this rank's experts, counted in the same
        :attr:`wire`."""
        return dataclasses.replace(self, pool=None, ring=None, ssm=None, shard_map_pool=False)

    def axis_size(self, axis: str) -> int:
        return int(mesh_axes(self.mesh)[axis])

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: Optional[str] = None
                   ) -> torch.Tensor:
        """``dist.all_reduce`` of ``t`` in place over ``axis``'s sub-group
        (default ``model``), counted in :attr:`wire`; a size-1 axis is a
        no-op.  Returns ``t``."""
        import torch.distributed as dist

        axis = self.rules.model if axis is None else axis
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {_REDUCE_OPS}, got {op!r}")
        if self.axis_size(axis) == 1:
            return t
        if isinstance(self.mesh, AbstractMesh):
            raise ValueError("collectives need a live DeviceMesh, not an AbstractMesh")
        self.wire.bytes += t.numel() * t.element_size()
        self.wire.calls += 1
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.mesh.get_group(axis))
        self.wire.seconds += time.perf_counter() - t0
        return t

    def collective_bytes(self) -> int:
        """Bytes this rank sent through collectives under this policy."""
        return self.wire.bytes


_ACTIVE_POLICY: ContextVar[Optional[ShardingPolicy]] = ContextVar(
    "repro_torch_dist_sharding_policy", default=None)


def current_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE_POLICY.get()


@contextlib.contextmanager
def activation_sharding(policy: Optional[ShardingPolicy]):
    """Install ``policy`` for the enclosed calls (None -> force no policy)."""
    token = _ACTIVE_POLICY.set(policy)
    try:
        yield policy
    finally:
        _ACTIVE_POLICY.reset(token)


def _redistribute(x, spec, mesh):
    return x.redistribute(mesh, to_placements(spec, mesh))


def constrain(x, rule_name: str):
    """Apply the active policy's named layout rule to ``x``.

    A plain tensor comes back unchanged (there is no implicit partitioner
    to hint); a ``DTensor`` is redistributed to the fitted spec.  Identity
    too when no policy is installed, when the policy has no such rule, or
    when no entry of the fitted spec survives the divisibility guard.
    """
    policy = current_policy()
    if policy is None or not isinstance(x, DTensor):
        return x
    spec = policy.specs.get(rule_name)
    if spec is None or len(spec) > x.ndim:
        return x
    fitted = _fit_spec(spec, tuple(x.shape), policy.mesh)
    if all(e is None for e in fitted):
        return x
    return _redistribute(x, fitted, policy.mesh)


def constrain_tree(tree, specs, mesh=None):
    """Redistribute every ``DTensor`` leaf of ``tree`` to the matching leaf
    of a spec tree (e.g. :func:`cache_shardings`' output).  Identity when
    ``specs`` is None or no mesh is resolvable; plain tensors and leaves
    whose spec is empty pass through untouched."""
    if specs is None:
        return tree
    if mesh is None:
        policy = current_policy()
        mesh = policy.mesh if policy is not None else None
    if mesh is None:
        return tree

    def one(leaf, spec):
        if not isinstance(leaf, DTensor) or spec is None or all(e is None for e in spec):
            return leaf
        return _redistribute(leaf, spec, mesh)

    if isinstance(tree, Mapping):
        return {k: constrain_tree(v, specs[k], mesh) if isinstance(v, Mapping) else one(v, specs[k])
                for k, v in tree.items()}
    return one(tree, specs)

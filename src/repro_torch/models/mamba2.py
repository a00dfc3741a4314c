"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

Each layer is a pre-norm residual around :func:`mamba_mix`: one input
projection split into ``z``, ``x``, ``B``, ``C`` and ``dt``, a depthwise
causal conv with SiLU over ``[x, B, C]``, the SSD recurrence over 64-dim
heads with one ``B``/``C`` group shared by every head, the ``D`` skip, the
``silu(z)`` gate, a grouped RMSNorm and the output projection.

Every SSD recurrence, prefill chunk and decode step alike, runs through the
hand-written CUDA kernel (``kernels/ssd_scan``) on the card and its plain
chunked form on the CPU.  The JAX package sends S=1 decode through
``ssd_decode_step`` instead; here decode is the kernel's one-token case
entered from the carried state, the same math up to rounding.  Neither
package claims that S=1 decode is bitwise chunked prefill for this family:
the chunked form reassociates.

:class:`Mamba2LM` holds one :class:`Mamba2Layer` per layer (the JAX
package stacks and scans them).  Decode state, stacked over layers, keeps
no K/V (``n_kv_layers == 0``)::

  ssm  : (n_layers, B, H, P, N) fp32       SSD state per slot
  conv : (n_layers, B, K-1, d_xbc) bf16    conv tail per slot (pre-conv inputs)

A decode step returns **new** ``ssm``/``conv`` tensors, so the scheduler
can restore the rows of inactive slots (:func:`kvcache.mask_slot_rows`).

Under a sharding policy whose :class:`~repro_torch.dist.sharding.SSMShard`
splits the heads (the scheduler's ``mesh=`` mode), each rank's ``ssm``
holds its heads of the state: the input projection, the conv and its tail
run whole on every rank of the ``model`` axis, the scan and the ``D`` skip
run on the rank's heads (``ssd_scan_shard``), and ``y`` is gathered over
``model`` as a SUM of a zero-filled buffer in y's dtype (exact: one rank
writes each element) before the gate, the norm and the output projection,
which see the whole of it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import current_policy
from . import layers
from .config import ArchConfig
from .layers import cast
from .transformer import _params, _store

# (group, leaf) pairs stored and computed with in fp32: the decay and step
# parameters, the D skip and both norm scales.
FP32_PARAMS = frozenset({("norm", "scale"), ("ssm", "A_log"), ("ssm", "dt_bias"),
                         ("ssm", "D"), ("ssm", "norm")})


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    d_xbc = di + 2 * s.d_state  # the conv covers [x, B, C]
    return s, di, nh, d_xbc


def init_mamba_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's parameter groups ``norm`` and ``ssm``, with the JAX
    package's distributions drawn from ``gen``."""
    s, di, nh, d_xbc = _dims(cfg)
    dev, f32 = gen.device, layers.PARAM_DTYPE
    d_in_proj = 2 * di + 2 * s.d_state + nh  # z, x, B, C, dt
    return {
        "norm": layers.init_norm(cfg.norm, cfg.d_model, dev),
        "ssm": {
            "in_proj": layers.dense_init(gen, cfg.d_model, d_in_proj),
            "conv_w": 0.1 * torch.randn(s.d_conv, d_xbc, generator=gen, device=dev, dtype=f32),
            "conv_b": torch.zeros(d_xbc, dtype=f32, device=dev),
            "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev)),
            "dt_bias": torch.zeros(nh, dtype=f32, device=dev),
            "D": torch.ones(nh, dtype=f32, device=dev),
            "norm": torch.ones(di, dtype=f32, device=dev),
            "out_proj": layers.dense_init(gen, di, cfg.d_model),
        },
    }


def causal_conv(p, xbc: torch.Tensor, prev: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d with SiLU over xbc (B, S, C), continuing
    from the carry ``prev`` (B, K-1, C) (zeros when None).  Returns
    ``(silu(conv + b), tail)``, the tail being the last K-1 inputs."""
    K = p["conv_w"].shape[0]
    B, S, C = xbc.shape
    if prev is None:
        prev = torch.zeros((B, K - 1, C), dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    out = sum(padded[:, i:i + S, :] * cast(p["conv_w"][i]) for i in range(K))
    return F.silu(out + cast(p["conv_b"])), padded[:, -(K - 1):].contiguous()


def mamba_mix(p, cfg: ArchConfig, x: torch.Tensor, state: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Sequence-mixing half of the block.  ``state={'ssm': (B, H, P, N)
    fp32, 'conv': (B, K-1, d_xbc)}`` given: a continuation (S=1 decode, or
    a chunk of chunked prefill) from that state, and the state it leaves is
    returned as new tensors (the given one is not written); None: a
    full-sequence forward from a zero state, which returns no state.  A
    continuation under a policy that splits the state's heads takes and
    returns this rank's heads of ``ssm``."""
    from ..kernels.ssd_scan import ssd_scan, ssd_scan_shard

    s, di, nh, d_xbc = _dims(cfg)
    B, L, _ = x.shape
    proj = x @ cast(p["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(proj, [di, di, s.d_state, s.d_state, nh], dim=-1)
    continuing = state is not None
    xbc, tail = causal_conv(p, torch.cat([xs, Bm, Cm], dim=-1),
                            state["conv"] if continuing else None)
    xs, Bm, Cm = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(B, L, nh, s.head_dim)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    policy = current_policy()
    shard = getattr(policy, "ssm", None)
    if continuing and shard is not None and shard.split:
        lo, hi = shard.heads()
        ys, h_final = ssd_scan_shard(xh, dtp, A, Bm, Cm, state["ssm"], shard=shard.index,
                                     n_shards=shard.count, chunk=s.chunk)
        ys = ys + xh[:, :, lo:hi] * p["D"].float()[lo:hi].to(ys.dtype)[None, None, :, None]
        y = torch.zeros((B, L, nh, s.head_dim), dtype=ys.dtype, device=x.device)
        y[:, :, lo:hi] = ys
        y = policy.all_reduce(y, "sum")
    else:
        y, h_final = ssd_scan(xh, dtp, A, Bm, Cm, state["ssm"] if continuing else None,
                              chunk=s.chunk)
        y = y + xh * p["D"].float().to(y.dtype)[None, None, :, None]
    new_state = {"conv": tail, "ssm": h_final} if continuing else None

    y = y.reshape(B, L, di) * F.silu(z)
    yf = y.float()  # grouped RMSNorm (one group)
    y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
         * p["norm"].float()).to(x.dtype)
    return y @ cast(p["out_proj"]), new_state


class Mamba2Layer(nn.Module):
    """Parameters of one layer, named as in the JAX parameter tree; the
    :data:`FP32_PARAMS` leaves are stored fp32, the rest bf16 (the value
    every use casts to)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        for group, tree in init_mamba_layer(gen, cfg).items():
            fp32 = tuple(name for g, name in FP32_PARAMS if g == group)
            setattr(self, group, _params(_store(tree, fp32=fp32)))


class Mamba2LM(nn.Module):
    """Attention-free SSD language model.  Parameters are drawn from
    ``generator`` (default: seed 0 on ``device``) with the JAX package's
    distributions; load other weights with ``load_state_dict`` (see
    :mod:`repro_torch.weights`)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, model on {device}")
        self.embedding = _params(_store(layers.init_embedding(generator, cfg)))
        self.layers = nn.ModuleList(Mamba2Layer(cfg, generator) for _ in range(cfg.n_layers))
        self.final_norm = _params(_store(layers.init_norm(cfg.norm, cfg.d_model, device)))

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    @property
    def n_kv_layers(self) -> int:
        """Layers that keep K/V: none."""
        return 0

    def _run(self, tokens: torch.Tensor, cache: Optional[Dict] = None):
        """Logits and each layer's new state (None without ``cache``; then
        each layer is rematerialized as ``cfg.remat`` says)."""
        cfg = self.cfg
        x = layers.embed_tokens(self.embedding, cfg, tokens)

        def layer(p, x):
            return x + mamba_mix(p.ssm, cfg, layers.apply_norm(cfg.norm, p.norm, x))[0]

        new = []
        for i, p in enumerate(self.layers):
            if cache is None:
                x = layers.remat(cfg.remat, functools.partial(layer, p), x)
                new.append(None)
                continue
            h = layers.apply_norm(cfg.norm, p.norm, x)
            h, st = mamba_mix(p.ssm, cfg, h, state={"ssm": cache["ssm"][i],
                                                    "conv": cache["conv"][i]})
            x = x + h
            new.append(st)
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        return layers.lm_head(self.embedding, cfg, x), new

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, padded_vocab)."""
        return self._run(tokens)[0]

    def loss_aux(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` -> (logits, a zero auxiliary loss)."""
        logits = self.apply(batch["tokens"])
        return logits, logits.new_zeros((), dtype=torch.float32)

    forward = apply

    # -- decode ------------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        """Tokens of K/V a cache keeps for ``seq_len``: none, the state is O(1)."""
        return 0

    def recurrent_rows(self, B: int) -> Dict[str, torch.Tensor]:
        """Zero recurrent state for ``B`` rows: ``ssm`` (n_layers, B, H, P,
        N) fp32 and ``conv`` (n_layers, B, K-1, d_xbc) bf16."""
        s, _, nh, d_xbc = _dims(self.cfg)
        n = self.cfg.n_layers
        return {
            "ssm": torch.zeros((n, B, nh, s.head_dim, s.d_state), dtype=torch.float32,
                               device=self.device),
            "conv": torch.zeros((n, B, s.d_conv - 1, d_xbc), dtype=layers.COMPUTE_DTYPE,
                                device=self.device),
        }

    def init_cache(self, B: int, seq_len: int) -> Dict[str, torch.Tensor]:
        """The recurrent rows and a shared ``length``; ``seq_len`` is taken
        for the interface's sake and changes no shape."""
        cache = self.recurrent_rows(B)
        cache["length"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return cache

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S_new), continuing every row from its state (S > 1 is
        a chunk of chunked prefill).  Returns the logits and a cache with
        new ``ssm``/``conv`` tensors and the advanced ``length``; the given
        cache is not written."""
        logits, new = self._run(tokens, cache)
        new_cache = dict(cache)
        new_cache["ssm"] = torch.stack([st["ssm"] for st in new])
        new_cache["conv"] = torch.stack([st["conv"] for st in new])
        new_cache["length"] = cache["length"] + tokens.shape[1]
        return logits, new_cache

    def prefill(self, tokens: torch.Tensor, *, seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward from a zero state that also returns the
        cache it leaves; ``seq_len`` changes no shape (the state is O(1))."""
        return self.decode_step(self.init_cache(tokens.shape[0], seq_len or 0), tokens)

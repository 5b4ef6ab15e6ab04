"""Mamba2 — SSD (state-space duality) blocks, arXiv:2405.21060.

The reference's ``models/mamba2.py`` on tensors. Training and prefill use
the chunked SSD algorithm: within a chunk of length Q a masked,
decay-weighted quadratic form; across chunks a small recurrent state
(B, H, P, N) carried by a loop over the chunks. Decode is the pure SSM
recurrence, one state update per token. All SSD math runs in f32, exactly
where the reference's does.

The projections are separate matrices (w_z/w_x/w_B/w_C/w_dt) and the
depthwise conv three per-segment kernels, under the reference's names, so a
checkpoint from either package restores in the other.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim (P = head_dim);
N = ssm_state; one B/C group shared across heads.

Two departures from the reference, neither of which changes a value the
reference computes finitely:

- **The decay's exponent is masked before ``exp``.** The reference takes
  ``exp(seg_t - seg_s)`` over the whole (Q, Q) tile and zeroes the upper
  triangle after the product; where a head's decay summed over a chunk
  passes about 88 those entries overflow to ``inf`` and their gradient is
  ``0 * inf = NaN``. Here the upper triangle's exponent is ``-inf`` before
  ``exp``, so those entries are 0 and so is their gradient.
- **Segment sums without ``cumsum``.** ``torch.cumsum`` on a floating CUDA
  tensor raises under deterministic algorithms. The within-chunk prefix
  sums are a product with a lower-triangular (Q, Q) ones matrix in f64,
  rounded once to f32: deterministic on the card, independent of the TF32
  setting, and never further from the exact sum than the reference's f32
  running sum is.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_rmsnorm

# one layer's mixer leaves, in the reference's names (f32 in every model:
# A_log, D, dt_bias)
LEAVES = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_xb", "conv_B",
          "conv_Bb", "conv_C", "conv_Cb", "A_log", "D", "dt_bias", "norm_w", "w_out")
F32_LEAVES = ("A_log", "D", "dt_bias")


def leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's leaf shapes."""
    D, DI, N, H, W = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_conv)
    return {"w_z": (D, DI), "w_x": (D, DI), "w_B": (D, N), "w_C": (D, N), "w_dt": (D, H),
            "conv_x": (W, DI), "conv_xb": (DI,), "conv_B": (W, N), "conv_Bb": (N,),
            "conv_C": (W, N), "conv_Cb": (N,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_w": (DI,), "w_out": (DI, D)}


def mamba_init(cfg: ModelConfig, generator: torch.Generator, *lead: int,
               dtype: torch.dtype, device: torch.device | str | None = None) -> dict:
    """The reference's ``mamba_init``, each leaf with ``lead`` dims in front
    (the layer stack): normal weights scaled by 1/sqrt(fan-in), the conv by
    1/sqrt(W), zero biases and norm, A in [-16, -1] (``A_log``), D = 1 and
    ``dt_bias`` with softplus(dt_bias) = 0.01, the last three in f32. The
    numbers differ from the reference's (another RNG stream); the
    distributions are the same."""
    dev = torch.device(device) if device is not None else generator.device
    shapes = leaf_shapes(cfg)
    H, W, D, DI = cfg.ssm_heads, cfg.ssm_conv, cfg.d_model, cfg.ssm_d_inner

    def normal(name: str, scale: float) -> torch.Tensor:
        shape = (*lead, *shapes[name])
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    def filled(name: str, row: torch.Tensor) -> torch.Tensor:
        return row.to(dev).expand(*lead, *shapes[name]).clone()

    p = {name: normal(name, 1.0 / np.sqrt(D)) for name in ("w_z", "w_x", "w_B", "w_C", "w_dt")}
    for name in ("conv_x", "conv_B", "conv_C"):
        p[name] = normal(name, 1.0 / np.sqrt(W))
    for name in ("conv_xb", "conv_Bb", "conv_Cb", "norm_w"):
        p[name] = torch.zeros((*lead, *shapes[name]), dtype=dtype, device=dev)
    p["A_log"] = filled("A_log", torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)))
    p["D"] = filled("D", torch.ones(H, dtype=torch.float32))
    p["dt_bias"] = filled("dt_bias", torch.full((H,), float(np.log(np.expm1(0.01))),
                                                dtype=torch.float32))
    p["w_out"] = normal("w_out", 1.0 / np.sqrt(DI))
    return {name: p[name] for name in LEAVES}


# each ssd_forward call's largest per-chunk decay exponent while
# decay_log() is open
_LOG: list | None = None


@contextlib.contextmanager
def decay_log():
    """Collects, per :func:`ssd_forward` call, the largest decay exponent
    summed over a chunk, max over batch, chunks and heads of |A| * sum(dt)
    (a detached 0-d f32 tensor on the call's device), into the yielded list.
    The reference's gradient overflows where this passes about 88. A
    rematerialised layer logs again when its backward recomputes it."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time + silu: u (B, S, Ch), w (W, Ch)."""
    W, S = w.shape[0], u.shape[1]
    out = u * w[-1]
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return F.silu((out + b).float()).to(u.dtype)


def _project(p: dict, x_in: torch.Tensor):
    """x (B, S, D) -> z (B, S, DI), xr, B_, C_, dt."""
    return (x_in @ p["w_z"], x_in @ p["w_x"], x_in @ p["w_B"], x_in @ p["w_C"],
            x_in @ p["w_dt"])


@functools.lru_cache(maxsize=None)
def _lower_ones(q: int, device: torch.device) -> torch.Tensor:
    """(Q, Q) f64 lower-triangular ones, one copy per chunk length and device."""
    return torch.tril(torch.ones((q, q), dtype=torch.float64, device=device))


def segment_sums(dA: torch.Tensor) -> torch.Tensor:
    """Prefix sums along dim 2 of (B, nc, Q, H) f32: the reference's
    ``cumsum`` as a product with lower-triangular ones in f64, rounded once
    to f32 (deterministic on the card, where ``cumsum`` would raise)."""
    ones = _lower_ones(dA.shape[2], dA.device)
    return torch.einsum("ij,bcjh->bcih", ones, dA.double()).float()


def ssd_forward(cfg: ModelConfig, p: dict, x_in: torch.Tensor):
    """Full-sequence SSD over one layer's weights ``p``.

    x_in: (B, S, D) -> (y (B, S, D), state {"h": (B, H, P, N) f32, "conv":
    (B, W-1, Ch) f32}): the state continues generation exactly where the
    sequence ended. S must divide into chunks of ``min(ssm_chunk, S)``.
    """
    B, S, _ = x_in.shape
    DI, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"S={S} not divisible by ssm_chunk={Q}")
    nc = S // Q
    W = cfg.ssm_conv

    z, xr, B_, C_, dt = _project(p, x_in)
    # conv state: the last W-1 *pre-conv* rows per segment (decode continues)
    conv_tail = torch.cat(
        [F.pad(t, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):] for t in (xr, B_, C_)],
        dim=-1,
    ).float()
    xr = _causal_conv(xr, p["conv_x"], p["conv_xb"])
    B_ = _causal_conv(B_, p["conv_B"], p["conv_Bb"])
    C_ = _causal_conv(C_, p["conv_C"], p["conv_Cb"])

    # f32 SSD quantities
    xh = xr.reshape(B, S, H, P).float()
    dtf = F.softplus(dt.float() + p["dt_bias"])                   # (B, S, H)
    A = -torch.exp(p["A_log"])                                    # (H,) negative
    dA = dtf * A                                                  # log-decay

    # chunked views
    xc = xh.reshape(B, nc, Q, H, P)
    Bc = B_.float().reshape(B, nc, Q, N)
    Cc = C_.float().reshape(B, nc, Q, N)
    dtc = dtf.reshape(B, nc, Q, H)

    seg = segment_sums(dA.reshape(B, nc, Q, H))                   # (B, nc, Q, H)
    total = seg[:, :, -1]                                         # (B, nc, H)
    if _LOG is not None:
        _LOG.append((-total).amax().detach())

    # intra-chunk (quadratic, masked decay kernel), heads leading:
    #   G[t, s] = (C_t . B_s) * exp(seg_t - seg_s) * dt_s   for s <= t
    # with the exponent masked before exp (see the module's docstring)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                  # (B, nc, Q, Q)
    seg_h = seg.transpose(2, 3)                                   # (B, nc, H, Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x_in.device).tril()
    expo = torch.where(mask, seg_h[..., :, None] - seg_h[..., None, :], -torch.inf)
    G = CB[:, :, None] * torch.exp(expo) * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", G, xc)

    # chunk states: S_c = sum_t exp(total - seg_t) * dt_t * B_t x_t^T
    w_state = torch.exp(total[:, :, None, :] - seg) * dtc         # (B, nc, Q, H)
    S_c = torch.einsum("bcqhp,bcqn->bchpn", w_state[..., None] * xc, Bc)

    # inter-chunk recurrence over the chunks (sequential, tiny state)
    h = x_in.new_zeros((B, H, P, N), dtype=torch.float32)
    h_prevs = []
    decay = torch.exp(total)                                      # (B, nc, H)
    for c in range(nc):
        h_prevs.append(h)                                         # state *before* chunk
        h = h * decay[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                         # (B, nc, H, P, N)

    # inter-chunk contribution: y_t += C_t . (exp(seg_t) * h_prev)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs) * torch.exp(seg)[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, DI).to(x_in.dtype)
    y = gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": conv_tail}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, the recurrence's type, or in f64 where it already is
    (the tests' f64 oracle runs the recurrence on f64 weights)."""
    return t if t.dtype == torch.float64 else t.float()


def ssm_decode_step(cfg: ModelConfig, p: dict, state: dict, x_tok: torch.Tensor):
    """One-token recurrence. x_tok: (B, 1, D); state: {"h": (B, H, P, N),
    "conv": (B, W-1, Ch)} f32 -> (y (B, 1, D), new state, new tensors)."""
    B = x_tok.shape[0]
    DI, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, B_, C_, dt = _project(p, x_tok)
    xBC = torch.cat([xr, B_, C_], dim=-1)[:, 0]                   # (B, Ch)

    window = torch.cat([state["conv"], _wide(xBC[:, None])], dim=1)   # (B, W, Ch)
    conv_w = _wide(torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1))
    conv_b = _wide(torch.cat([p["conv_xb"], p["conv_Bb"], p["conv_Cb"]]))
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, conv_w) + conv_b)
    new_conv = window[:, 1:]

    xr = conv_out[:, :DI].reshape(B, H, P)
    Bf = conv_out[:, DI : DI + N]
    Cf = conv_out[:, DI + N :]
    dtf = F.softplus(_wide(dt[:, 0]) + p["dt_bias"])              # (B, H)
    decay = torch.exp(dtf * -torch.exp(p["A_log"]))               # (B, H)

    h = state["h"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", dtf[:, :, None] * xr, Bf)
    y = torch.einsum("bn,bhpn->bhp", Cf, h) + xr * p["D"][None, :, None]
    y = y.reshape(B, 1, DI).to(x_tok.dtype)
    y = gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": new_conv}


def init_ssm_state(cfg: ModelConfig, batch: int, *lead: int,
                   device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.float32) -> dict:
    """A zero state {"h": (*lead, B, H, P, N), "conv": (*lead, B, W-1, Ch)},
    f32 (``lead``: the layer stack of a model's cache)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ch = cfg.ssm_d_inner + 2 * N
    return {
        "h": torch.zeros((*lead, batch, H, P, N), dtype=dtype, device=device),
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, ch), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# naive O(S) recurrence oracle (tests only)
# ---------------------------------------------------------------------------

def ssd_reference(cfg: ModelConfig, p: dict, x_in: torch.Tensor) -> torch.Tensor:
    """Sequential recurrence: must match ssd_forward to f32 tolerance (in
    f64 on f64 weights and inputs)."""
    state = init_ssm_state(cfg, x_in.shape[0], device=x_in.device,
                           dtype=_wide(x_in[:0]).dtype)
    ys = []
    for t in range(x_in.shape[1]):
        y, state = ssm_decode_step(cfg, p, state, x_in[:, t : t + 1])
        ys.append(y)
    return torch.cat(ys, dim=1)

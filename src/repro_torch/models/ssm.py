"""Mamba2 (SSD — state-space duality, arXiv:2405.21060), chunked form.

Port of ``repro/models/ssm.py``. Prefill runs the block-decomposed SSD
algorithm: intra-chunk masked products plus an inter-chunk recurrence (a
Python loop over chunks), O(L * Q) compute with O(1) state. Decode carries
(conv window, SSM state) per layer, the attention-free analogue of a KV
cache. Group convention: n_groups = 1 (B/C shared across heads).

On DTensors (a mesh of ranks) a mixer runs on each rank's batch rows with
its whole parameters, on local tensors (``_dtensor.on_rows``): the same
arithmetic per row, replicated over the model axis, where DTensor's own
propagation of the convolution's slices fails on some torch releases.

The depthwise causal convolution is written as the sum of its K shifted
slices, each product in float32: on the card ``F.conv1d`` goes through
cuDNN, whose float32 is TF32 unless ``torch.backends.cudnn.allow_tf32`` is
off. The SSD products take float32 operands, as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._dtensor import is_dtensor, on_rows

from .layers import rms_norm

__all__ = ["SSMParamsSpec", "ssm_forward", "ssm_decode_step", "SSMState", "ssm_dims"]


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, conv_dim) last inputs of the causal conv
    ssd: torch.Tensor  # (B, H, P, N) state matrix


def ssm_dims(d_model: int, expand: int, headdim: int, state: int, conv_k: int):
    d_inner = expand * d_model
    nheads = d_inner // headdim
    conv_dim = d_inner + 2 * state  # x + B + C (G=1)
    d_in_proj = 2 * d_inner + 2 * state + nheads  # z, xBC, dt
    return dict(
        d_inner=d_inner, nheads=nheads, conv_dim=conv_dim, d_in_proj=d_in_proj,
        headdim=headdim, state=state, conv_k=conv_k,
    )


class SSMParamsSpec(NamedTuple):
    """Per-layer parameter shapes (used by the init code in model.py)."""

    in_proj: tuple  # (D, d_in_proj)
    conv_w: tuple  # (K, conv_dim)
    conv_b: tuple  # (conv_dim,)
    a_log: tuple  # (H,)
    d_skip: tuple  # (H,)
    dt_bias: tuple  # (H,)
    norm_w: tuple  # (d_inner,)
    out_proj: tuple  # (d_inner, D)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal cross-correlation (no kernel flip). x: (B, L, C), w: (K, C).

    out[t] = sum_i x[t + i - (K - 1)] * w[i], zero before the start; the sum
    in float32, rounded once to x's dtype, then the bias added in it.
    """
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).float()
    w32 = w.to(x.dtype).float()
    out = xp[:, 0:l] * w32[0]
    for i in range(1, k):
        out = out + xp[:, i : i + l] * w32[i]
    return out.to(x.dtype) + b.to(x.dtype)


def _segsum_chunk(dA: torch.Tensor) -> torch.Tensor:
    """exp-safe segment sums within a chunk: out[..., i, j] = sum_{j<t<=i} dA_t."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., i, j)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssm_forward(p: dict, u: torch.Tensor, cfg, *, return_state: bool = False):
    """One Mamba2 mixer. u: (B, L, D) -> (B, L, D) (+ final SSMState)."""
    if is_dtensor(u):
        return on_rows(lambda lp, lu: ssm_forward(lp, lu, cfg, return_state=return_state), p, u)
    dims = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
    d_inner, h, n, pdim = dims["d_inner"], dims["nheads"], dims["state"], dims["headdim"]
    b, l_real, _ = u.shape
    q = min(cfg.ssm_chunk, l_real)
    pad = (-l_real) % q
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
    l = l_real + pad
    nc = l // q

    zxbcdt = torch.matmul(u, p["in_proj"].to(u.dtype))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner : d_inner + dims["conv_dim"]]
    dt = zxbcdt[..., -h:]

    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x = xbc[..., :d_inner].reshape(b, l, h, pdim)
    bmat = xbc[..., d_inner : d_inner + n]  # (B, L, N) — G=1
    cmat = xbc[..., d_inner + n :]  # (B, L, N)

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, L, H)
    if pad:
        # padded positions must be identity state updates: dt = 0
        valid = (torch.arange(l, device=u.device) < l_real)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(p["a_log"].float())  # (H,)
    da = dt * a  # (B, L, H)

    # --- chunked SSD ------------------------------------------------------
    xc = x.reshape(b, nc, q, h, pdim).float()
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    dac = da.reshape(b, nc, q, h).permute(0, 1, 3, 2)  # (B, NC, H, Q)
    dtc = dt.reshape(b, nc, q, h)

    # intra-chunk: y[i] = sum_{j<=i} C_i.B_j exp(sum dA (j,i]) dt_j x_j
    lmat = torch.exp(_segsum_chunk(dac))  # (B, NC, H, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B, NC, Q, Q)
    m = scores[:, :, None] * lmat  # (B, NC, H, Q, Q)
    y_diag = torch.einsum("bchij,bcjh,bcjhp->bcihp", m, dtc, xc)

    # chunk states: S_c = sum_j exp(sum dA (j, Q]) dt_j B_j x_j^T
    cum = torch.cumsum(dac, dim=-1)  # (B, NC, H, Q)
    total = cum[..., -1:]
    decay_out = torch.exp(total - cum)
    states = torch.einsum("bcjn,bchj,bcjh,bcjhp->bchpn", bc, decay_out, dtc, xc)

    # inter-chunk recurrence: prev[c] is the state before chunk c
    chunk_decay = torch.exp(total[..., 0])  # (B, NC, H)
    s = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=u.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_final = s
    prev = torch.stack(prevs, dim=1)  # (B, NC, H, P, N)

    decay_in = torch.exp(cum)  # (B, NC, H, Q)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, prev, decay_in)

    y = (y_diag + y_off).reshape(b, l, h, pdim)
    y = y + xc.reshape(b, l, h, pdim) * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, l, d_inner).to(u.dtype)[:, :l_real]

    # gated RMSNorm then output projection
    y = rms_norm(y * F.silu(z[:, :l_real]), p["norm_w"])
    out = torch.matmul(y, p["out_proj"].to(u.dtype))

    if not return_state:
        return out
    km1 = dims["conv_k"] - 1
    raw_xbc = zxbcdt[..., d_inner : d_inner + dims["conv_dim"]]
    conv_state = raw_xbc[:, l_real - km1 : l_real, :]
    return out, SSMState(conv=conv_state, ssd=s_final)


def ssm_decode_step(p: dict, u_t: torch.Tensor, state: SSMState, cfg):
    """One-token step. u_t: (B, D) -> (B, D), new state."""
    if is_dtensor(u_t):
        step = lambda lp, lu, conv, ssd: ssm_decode_step(lp, lu, SSMState(conv, ssd), cfg)
        return on_rows(step, p, u_t, state.conv, state.ssd)
    dims = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
    d_inner, h, n, pdim = dims["d_inner"], dims["nheads"], dims["state"], dims["headdim"]
    b = u_t.shape[0]

    zxbcdt = torch.matmul(u_t, p["in_proj"].to(u_t.dtype))
    z = zxbcdt[..., :d_inner]
    xbc_t = zxbcdt[..., d_inner : d_inner + dims["conv_dim"]]
    dt = zxbcdt[..., -h:]

    # conv over the cached window
    window = torch.cat([state.conv, xbc_t[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    xbc = F.silu(conv_out + p["conv_b"].float())
    x = xbc[..., :d_inner].reshape(b, h, pdim)
    bvec = xbc[..., d_inner : d_inner + n]
    cvec = xbc[..., d_inner + n :]

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, H)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)  # (B, H)

    s_new = state.ssd * da[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, x, bvec)
    y = torch.einsum("bhpn,bn->bhp", s_new, cvec) + x * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, d_inner).to(u_t.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    out = torch.matmul(y, p["out_proj"].to(u_t.dtype))
    return out, SSMState(conv=window[:, 1:, :], ssd=s_new)

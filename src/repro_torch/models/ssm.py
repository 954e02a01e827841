"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

PyTorch port of ``repro.models.ssm``.  Chunked dual form: within chunks of
length Q the recurrence is evaluated as masked attention-like products;
across chunks a loop over the chunks carries the [H, N, P] state (the
reference's ``u_scan``).  Decode is the O(1) recurrent step.

Layout: d_inner = expand * d_model; H = d_inner / headdim heads of dim P;
B/C have G groups shared by H/G heads (GQA-like, ``repeat_interleave``);
state size N.  The projections are split (z, x, B, C, dt), as in the
reference.  Numerics are the reference's: the segment sums are masked to
-inf BEFORE ``exp`` (masking after leaks NaN into the backward pass); the
cumulative sums, decays and states are float32.

With ``REPRO_SSM_SHARD_HEADS=1`` the intra-chunk [B, nc, Q, Q, H] tensors
are constrained to heads over "model" (``_hs``), as in the reference; the
constraint acts only on a DTensor laid out on a planning mesh (the dry
run), every other tensor passes unchanged.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import P as PSpec, constrain
from .layers import ninit, rms_norm

_HEADS = PSpec(None, None, None, None, "model")


def _hs(x, spec):
    """Head-sharding constraint for the intra-chunk SSD tensors
    (``REPRO_SSM_SHARD_HEADS=1``; a no-op on a tensor that is not laid out
    on a mesh).  The [B, nc, Q, Q, H] decay and score tensors otherwise
    replicate on the model axis and dominate per-device memory."""
    if os.environ.get("REPRO_SSM_SHARD_HEADS") != "1":
        return x
    return constrain(x, spec)


def init_ssm_block(seed, path, cfg, dtype, device):
    D, din = cfg.d_model, cfg.d_inner
    H, G, N, K = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_dconv
    GN = G * N
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    const = lambda a: torch.from_numpy(a).to(dtype=dtype, device=device)
    return {
        "norm": z(D),
        "z_proj": ninit(seed, f"{path}/z", (D, din), 0.02, dtype, device),
        "x_proj": ninit(seed, f"{path}/x", (D, din), 0.02, dtype, device),
        "B_proj": ninit(seed, f"{path}/B", (D, GN), 0.02, dtype, device),
        "C_proj": ninit(seed, f"{path}/C", (D, GN), 0.02, dtype, device),
        "dt_proj": ninit(seed, f"{path}/dt", (D, H), 0.02, dtype, device),
        "conv_x_w": ninit(seed, f"{path}/cx", (K, din), 0.2, dtype, device),
        "conv_x_b": z(din),
        "conv_B_w": ninit(seed, f"{path}/cB", (K, GN), 0.2, dtype, device),
        "conv_B_b": z(GN),
        "conv_C_w": ninit(seed, f"{path}/cC", (K, GN), 0.2, dtype, device),
        "conv_C_b": z(GN),
        "A_log": const(np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))),
        "D_skip": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": torch.full((H,), float(np.log(np.e - 1)), dtype=dtype,
                              device=device),
        "gate_norm": z(din),
        "out_proj": ninit(seed, f"{path}/out", (din, D),
                          0.02 / np.sqrt(2 * cfg.n_layers), dtype, device),
    }


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv1d + silu over [B, S, C] (d_conv taps).

    state: trailing (d_conv - 1) inputs from the previous call (decode).
    Returns (activated output, new state)."""
    K = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b), up[:, -(K - 1):]


def _project(cfg, params, x):
    h = rms_norm(x, params["norm"])
    return (h @ params["z_proj"], h @ params["x_proj"], h @ params["B_proj"],
            h @ params["C_proj"], h @ params["dt_proj"])


def _convs(params, xr, Br, Cr, states=(None, None, None)):
    return [_causal_conv(u, params[f"conv_{n}_w"], params[f"conv_{n}_b"], s)
            for u, n, s in zip((xr, Br, Cr), "xBC", states)]


def ssd_forward(cfg, params, x):
    """Train/prefill path.  x: [B, S, D] -> (x', (ssm_state, conv_states));
    S must be a multiple of ``min(ssm_chunk, S)``."""
    B_, S, D = x.shape
    H, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"pad the sequence ({S}) to a multiple of "
                         f"ssm_chunk ({Q})")
    nc = S // Q

    z, xr, Br, Cr, dt = _project(cfg, params, x)
    (xr, cvx), (Br, cvB), (Cr, cvC) = _convs(params, xr, Br, Cr)

    dt = F.softplus(dt.float() + params["dt_bias"].float())      # [B,S,H]
    A = -torch.exp(params["A_log"].float())                       # [H]

    # chunked SSD: [B, nc, Q, ...]
    xc = xr.reshape(B_, nc, Q, H, P).float()
    Bc = Br.reshape(B_, nc, Q, G, N).float()
    Cc = Cr.reshape(B_, nc, Q, G, N).float()
    dtc = dt.reshape(B_, nc, Q, H)
    rep = H // G

    cum = torch.cumsum(dtc * A, dim=2)                            # [B,nc,Q,H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Qq,Qk,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: i<j entries are positive and overflow
    L = _hs(torch.exp(seg.masked_fill(~causal[:, :, None], -torch.inf)),
            _HEADS)

    # intra-chunk: y_i += sum_j (C_i . B_j) L_ij dt_j x_j
    Bh = Bc.repeat_interleave(rep, dim=3)                 # [B,nc,Q,H,N]
    Ch = Cc.repeat_interleave(rep, dim=3)
    cb = _hs(torch.einsum("bcqhn,bckhn->bcqkh", Ch, Bh), _HEADS)
    w = _hs(cb * L * dtc[:, :, None], _HEADS)
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xc)

    # chunk states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)
    sb = Bh * (dtc * decay_out)[..., None]
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", sb, xc)

    # inter-chunk scan: state_{c+1} = exp(sum dA_c) state_c + S_c; each
    # chunk reads the state ENTERING it
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # [B,nc,H]
    state = x.new_zeros((B_, H, N, P), dtype=torch.float32)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    states_in = torch.stack(states_in, dim=1)             # [B,nc,H,N,P]

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) * state_in)
    y = y + torch.einsum("bcqhn,bchnp->bcqhp",
                         Ch * torch.exp(cum)[..., None], states_in)

    y = y.reshape(B_, S, H, P) \
        + params["D_skip"].float()[None, None, :, None] \
        * xc.reshape(B_, S, H, P)
    y = y.reshape(B_, S, cfg.d_inner)
    y = rms_norm(y.to(x.dtype), params["gate_norm"]) * F.silu(z)
    return x + y @ params["out_proj"], (state, (cvx, cvB, cvC))


def ssd_decode_step(cfg, params, x, state):
    """O(1) recurrent step.  x: [B, 1, D]; state = (ssm [B,H,N,P] f32,
    (conv_x, conv_B, conv_C) trailing inputs)."""
    ssm_state, convs = state
    B_ = x.shape[0]
    H, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state

    z, xr, Br, Cr, dt = _project(cfg, params, x)
    (xr, cvx), (Br, cvB), (Cr, cvC) = _convs(params, xr, Br, Cr, convs)

    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # [B,H]
    A = -torch.exp(params["A_log"].float())
    rep = H // G
    Bh = Br.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cr.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()

    decay = torch.exp(dt * A)                                     # [B,H]
    xf = xr.reshape(B_, H, P).float()
    ssm_state = (ssm_state * decay[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhnp", Bh * dt[..., None], xf))
    y = torch.einsum("bhn,bhnp->bhp", Ch, ssm_state)
    y = y + params["D_skip"].float()[None, :, None] * xf
    y = y.reshape(B_, 1, cfg.d_inner)
    y = rms_norm(y.to(x.dtype), params["gate_norm"]) * F.silu(z)
    return x + y @ params["out_proj"], (ssm_state, (cvx, cvB, cvC))

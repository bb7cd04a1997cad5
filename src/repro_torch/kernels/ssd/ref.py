"""Plain PyTorch versions of the SSD intra-chunk kernel.

The same function as the JAX package's ``kernels/ssd/ref.py::
ssd_chunk_ref`` (one chunk) and its Pallas kernel (every (batch, chunk,
head) at once): for each chunk, a = dt·A and its inclusive cumsum
acum, the causal decay-weighted product
y_i = Σ_{j≤i} (C_i·B_j) exp(acum_i − acum_j) dt_j x_j, the chunk state
Σ_j x_j ⊗ B_j dt_j exp(acum_last − acum_j) and the chunk decay
exp(acum_last).  exp is taken of 0 above the diagonal, where acum_i -
acum_j > 0 can overflow: the values are those of masking exp(diff), and
autograd's gradient stays finite (inf * 0 would make it NaN; the JAX
package's reference masks after exp and gives NaN gradients once a
chunk's decay passes exp(-88)).  Everything is float32.  The wrapper runs these on CPU
tensors; ``chip_smoke.py`` and the card tests hold the kernel against
them.  ``ssd_chunk_bwd_ref`` is the backward of the batched step, as
explicit formulas (the backward kernel's plain version).
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_chunk_batched_ref", "ssd_chunk_bwd_ref",
           "ssd_dA_scale"]


def _causal(Q: int, device):
    ar = torch.arange(Q, device=device)
    return ar[:, None] >= ar[None, :]


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """One chunk, one batch element.

    x: (Q,H,P) dt: (Q,H) A: (H,) Bm/Cm: (Q,N)
    returns (y_intra (Q,H,P), sstate (H,P,N), chunk_decay (H,))
    """
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    acum = torch.cumsum(dt * A, dim=0)                 # (Q,H)
    CB = torch.einsum("qn,sn->qs", Cm, Bm)             # (Q,Q)
    diff = acum[:, None, :] - acum[None, :, :]         # (Q,Q,H)
    mask = _causal(x.shape[0], x.device)[..., None]
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    M = CB[..., None] * L * dt[None, :, :]             # source dt
    y = torch.einsum("qsh,shp->qhp", M, x)
    dte = torch.exp(acum[-1:, :] - acum)               # (Q,H)
    sstate = torch.einsum("qn,qhp->hpn", Bm, x * (dt * dte)[..., None])
    return y, sstate, torch.exp(acum[-1])


def ssd_chunk_batched_ref(x, dt, A, Bm, Cm):
    """Every chunk at once, the Pallas kernel's signature.

    x: (B,c,Q,H,P) dt: (B,c,Q,H) A: (H,) Bm/Cm: (B,c,Q,N)
    -> (y_intra (B,c,Q,H,P), sstate (B,c,H,P,N), decay (B,c,H)), float32
    """
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    acum = torch.cumsum(dt * A, dim=2)                 # (B,c,Q,H)
    CB = torch.einsum("bcqn,bcsn->bcqs", Cm, Bm)       # (B,c,Q,Q)
    diff = acum[..., :, None, :] - acum[..., None, :, :]   # (B,c,Q,Q,H)
    mask = _causal(x.shape[2], x.device)[..., None]
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    M = CB[..., None] * L * dt[:, :, None, :, :]
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, x)
    dte = torch.exp(acum[:, :, -1:, :] - acum)
    sstate = torch.einsum("bcqn,bcqhp->bchpn", Bm, x * (dt * dte)[..., None])
    return y, sstate, torch.exp(acum[:, :, -1, :])


def ssd_chunk_bwd_ref(x, dt, A, Bm, Cm, dy=None, dstate=None, ddecay=None):
    """The backward of ``ssd_chunk_batched_ref``: the cotangents dy
    (B,c,Q,H,P), dstate (B,c,H,P,N) and ddecay (B,c,H) of its three
    outputs (None counts as zeros) -> (dx, ddt, dA, dB, dC), float32.

    Per (b, c, h), with CB = C.B^T, the causal L_ij = exp(acum_i -
    acum_j), M = CB o L o dt_j, dte = exp(acum_last - acum) and
    w = dt o dte: dM = dy.x^T (causal), G = dM o L, dx = M^T.dy +
    w o (B.dstate^T); dCB = sum_h G_h o dt_h (B and C are shared by the
    heads), dC = dCB.B, dB = dCB^T.C + sum_h w_h o (x_h.dstate_h);
    dw_j = x_j.dstate.B_j; R = G o CB o dt_j; dacum = rowsum(R) -
    colsum(R) - dw o w, plus sum_j dw_j w_j + ddecay exp(acum_last) on
    the last row; da = the reverse cumsum of dacum; ddt = colsum(G o CB)
    + dw o dte + A da; dA = sum over b, c and rows of da o dt.
    """
    return _bwd(x, dt, A, Bm, Cm, dy, dstate, ddecay)[:5]


def ssd_dA_scale(x, dt, A, Bm, Cm, dy=None, dstate=None, ddecay=None):
    """The scale of dA's rounding error, per head: the sum of its terms'
    magnitudes, sum over b, c and rows of |da o dt| (float32).  Those
    terms cancel, so a float32 dA summed in any order sits ~1e-4 of
    |dA| from the exact sum (the plain version too, at the kernel test's
    draws); its error is held against this scale instead."""
    da, dt = _bwd(x, dt, A, Bm, Cm, dy, dstate, ddecay)[5], dt.float()
    return (da * dt).abs().sum((0, 1, 2))


def _bwd(x, dt, A, Bm, Cm, dy, dstate, ddecay):
    """``ssd_chunk_bwd_ref``'s gradients and da."""
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    Bsz, c, Q, H, P = x.shape
    N = Bm.shape[-1]
    dy = torch.zeros_like(x) if dy is None else dy.float()
    dstate = (x.new_zeros((Bsz, c, H, P, N)) if dstate is None
              else dstate.float())
    ddecay = (x.new_zeros((Bsz, c, H)) if ddecay is None
              else ddecay.float())
    acum = torch.cumsum(dt * A, dim=2)                 # (B,c,Q,H)
    CB = torch.einsum("bcqn,bcsn->bcqs", Cm, Bm)       # (B,c,i,j)
    mask = _causal(Q, x.device)[..., None]             # (i,j,1)
    diff = acum[..., :, None, :] - acum[..., None, :, :]   # (B,c,i,j,H)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    dtj = dt[:, :, None, :, :]                         # (B,c,1,j,H)
    M = CB[..., None] * L * dtj
    dM = torch.where(mask, torch.einsum("bcihp,bcjhp->bcijh", dy, x), 0.0)
    G = dM * L
    dte = torch.exp(acum[:, :, -1:, :] - acum)         # (B,c,Q,H)
    w = dt * dte
    U = torch.einsum("bcjn,bchpn->bcjhp", Bm, dstate)  # (B,c,Q,H,P)
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dy) + w[..., None] * U
    dCB = (G * dtj).sum(-1)                            # (B,c,i,j)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bm)
    V = torch.einsum("bcjhp,bchpn->bcjhn", x, dstate)  # (B,c,Q,H,N)
    dB = (torch.einsum("bcij,bcin->bcjn", dCB, Cm)
          + torch.einsum("bcjh,bcjhn->bcjn", w, V))
    dw = (x * U).sum(-1)                               # (B,c,Q,H)
    GCB = G * CB[..., None]
    R = GCB * dtj
    dacum = R.sum(3) - R.sum(2) - dw * w
    last = (dw * w).sum(2) + ddecay * torch.exp(acum[:, :, -1, :])
    dacum = torch.cat([dacum[:, :, :-1], dacum[:, :, -1:] + last[:, :, None]],
                      dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dacum, (2,)), 2), (2,))
    ddt = GCB.sum(2) + dw * dte + A * da
    dA = (da * dt).sum((0, 1, 2))
    return dx, ddt, dA, dB, dC, da

"""Plain PyTorch versions of the SSD intra-chunk kernel.

The same function as the JAX package's ``kernels/ssd/ref.py::
ssd_chunk_ref`` (one chunk) and its Pallas kernel (every (batch, chunk,
head) at once): for each chunk, a = dt·A and its inclusive cumsum
acum, the causal decay-weighted product
y_i = Σ_{j≤i} (C_i·B_j) exp(acum_i − acum_j) dt_j x_j, the chunk state
Σ_j x_j ⊗ B_j dt_j exp(acum_last − acum_j) and the chunk decay
exp(acum_last).  Everything is float32.  The wrapper runs these on CPU
tensors; ``chip_smoke.py`` and the card tests hold the kernel against
them.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunk_ref", "ssd_chunk_batched_ref"]


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
    L = torch.where(mask, torch.exp(diff), 0.0)
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
    L = torch.where(mask, torch.exp(diff), 0.0)
    M = CB[..., None] * L * dt[:, :, None, :, :]
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, x)
    dte = torch.exp(acum[:, :, -1:, :] - acum)
    sstate = torch.einsum("bcqn,bcqhp->bchpn", Bm, x * (dt * dte)[..., None])
    return y, sstate, torch.exp(acum[:, :, -1, :])

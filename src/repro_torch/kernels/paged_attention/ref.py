"""Plain PyTorch version of paged decode attention, via dense gather.

Mirrors ``repro.kernels.paged_attention.ref.paged_attention_ref``:
gathers each sequence's K/V blocks through its block table into a
dense (B, T, K, hd) view, masks everything past the sequence frontier
(t > pos) or outside the sliding window, and runs two-pass softmax in
fp32.  The wrapper in ``ops.py`` runs it for CPU tensors, and the
tests and ``chip_smoke.py`` hold the CUDA kernel against it.
"""
import torch

NEG_INF = -2.0e38


def paged_attention_ref(q, kp, vp, bt, pos, *, window: int = 0,
                        softcap: float = 0.0):
    """q (B, H, hd); kp/vp (n_blocks, bs, K, hd); bt (B, nbmax) int32;
    pos (B,) int32 absolute position of the entry just written.
    Returns (B, H, hd) in q.dtype."""
    B, H, hd = q.shape
    _, bs, K, _ = kp.shape
    G = H // K
    T = bt.shape[1] * bs
    idx = bt.long()
    kd = kp[idx].reshape(B, T, K, hd).float()
    vd = vp[idx].reshape(B, T, K, hd).float()
    qf = q.float().reshape(B, K, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qf * hd ** -0.5, kd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t_ids = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    valid = t_ids <= pos[:, None]
    if window > 0:
        valid &= t_ids > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, vd)
    return o.reshape(B, H, hd).to(q.dtype)

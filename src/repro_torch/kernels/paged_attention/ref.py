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


MERGE_GROUP = 16       # live splits merged together first, as in the kernel


def _merge(parts):
    """(live, m, l, acc) of several partials merged in list order: the
    common max, then l and acc rescaled by exp(m - max) and summed."""
    mx = torch.full_like(parts[0][1], NEG_INF)
    for live, m, _, _ in parts:
        mx = torch.where(live, torch.maximum(mx, m), mx)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][3])
    any_live = torch.zeros_like(parts[0][0])
    for live, m, l, a in parts:
        w = torch.where(live, torch.exp(m - mx), 0.0)
        den = den + w * l
        acc = acc + w[..., None] * a
        any_live = any_live | live
    return any_live, mx, den, acc


def paged_attention_split_ref(q, kp, vp, bt, pos, *, n_split: int,
                              window: int = 0, softcap: float = 0.0):
    """The CUDA kernel's order of work, in plain PyTorch: the table's
    T positions cut into splits of ceil(T / n_split); in each split that
    holds a live position, one max m and one sum l of exp(s - m) per
    head and acc = sum exp(s - m) v; then each group of MERGE_GROUP live
    splits merged in split order (the common max, l and acc rescaled by
    exp(m - max) and summed), the groups merged likewise, and
    acc / max(l, 1e-30).  The tests hold it against the JAX package's
    kernel and reference; the wrapper never runs it."""
    B, H, hd = q.shape
    _, bs, K, _ = kp.shape
    G = H // K
    T = bt.shape[1] * bs
    split_len = -(-T // n_split)
    idx = bt.long()
    kd = kp[idx].reshape(B, T, K, hd).float()
    vd = vp[idx].reshape(B, T, K, hd).float()
    qf = q.float().reshape(B, K, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qf * hd ** -0.5, kd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t_ids = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    valid = t_ids <= pos[:, None]
    t_lo = torch.zeros_like(pos)
    if window > 0:
        valid &= t_ids > pos[:, None] - window
        t_lo = (pos - window + 1).clamp(min=0)
    first = (t_lo // split_len).long()[:, None, None]   # each row's first live split
    groups = [[] for _ in range(-(-n_split // MERGE_GROUP))]   # partials a group
    for j, a in enumerate(range(0, T, split_len)):
        v = valid[:, None, None, a:a + split_len]
        live = v.any(-1)                            # (B, 1, 1)
        sj = torch.where(v, s[..., a:a + split_len], float("-inf"))
        m = torch.where(live, sj.amax(-1), 0.0)
        p = torch.exp(sj - m[..., None])            # 0 off the live range
        acc = torch.einsum("bkgt,btkh->bkgh", p, vd[:, a:a + split_len])
        grp = (j - first) // MERGE_GROUP            # (B, 1, 1), where live
        for g, parts in enumerate(groups):
            parts.append((live & (grp == g), m, p.sum(-1), acc))
    _, _, den, out = _merge([_merge(parts) for parts in groups])
    out = out / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)

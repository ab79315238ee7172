"""Plain PyTorch version of forward flash attention.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: dense
softmax attention in fp32 with the causal / sliding-window mask at
-2e38 and ``softcap * tanh(s / softcap)``, GQA by grouping the H / K
query heads of a kv head.  It walks the queries ``q_chunk`` at a time,
so that the (chunk, S) score block, not the (S, S) one, is what exists:
at S = 8192 the whole block would not fit beside the model.  The wrapper
in ``ops.py`` runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
"""
import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_chunk: int = 1024):
    """q (B, S, H, hd); k/v (B, S, K, hd), K | H.  Returns (B, S, H, hd)
    in q.dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    j = torch.arange(S, device=q.device)[None, :]
    for c0 in range(0, S, q_chunk):
        c1 = min(c0 + q_chunk, S)
        qf = q[:, c0:c1].float().reshape(B, c1 - c0, K, G, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qf * hd ** -0.5, kf)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        i = torch.arange(c0, c1, device=q.device)[:, None]
        ok = torch.ones((c1 - c0, S), dtype=torch.bool, device=q.device)
        if causal:
            ok &= j <= i
        if window > 0:
            ok &= j > i - window
        s = torch.where(ok, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,btkh->bskgh", p, vf)
        out[:, c0:c1] = o.reshape(B, c1 - c0, H, hd).to(q.dtype)
    return out

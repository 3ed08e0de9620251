"""Plain PyTorch versions of the port's kernels.

Written the way ``repro/kernels/ref.py`` writes the JAX oracles: dense,
fp32, deliberately naive. On a CPU tensor the kernel wrappers in
``kernels/ops.py`` use these; on the card ``chip_smoke.py`` holds each
kernel against them. They compute in fp32; a caller on the card turns
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``) so the
products stay fp32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q [B,Sq,H,D], k/v [B,Sk,K,Dv]; H % K == 0. fp32 softmax, dense."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(D)
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kj <= qi
        if window:
            m &= kj > qi - window
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos, position, *,
                         window: int = 0):
    """One-token decode. q [B,H,D]; caches [B,C,K,D]; pos [B,C] absolute
    positions (-1 empty); position [B] current."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) / math.sqrt(D)
    cur = position[:, None]
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= pos > (cur - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return o.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, position):
    """One-token decode over a paged pool, after the reference's
    ``paged_attention_reference`` (``repro/paged/attention.py:38-57``).
    q [B,H,D]; pools [P,ps,K,D]; block_tables [B,nb] (-1 = unallocated,
    gathers page 0 and is masked); position [B] (last valid logical
    index; -1 masks every slot, so the row is the uniform mean of the
    gathered V rows) -> [B,H,D]. Gather, then a masked fp32 softmax."""
    B, H, D = q.shape
    ps, K = k_pool.shape[1], k_pool.shape[2]
    G = H // K
    pages = torch.clamp(block_tables, min=0).long()
    nb = pages.shape[1]
    k = k_pool[pages].reshape(B, nb * ps, K, D)
    v = v_pool[pages].reshape(B, nb * ps, K, v_pool.shape[-1])
    idx = torch.arange(nb * ps, device=q.device)
    allocated = torch.repeat_interleave(block_tables >= 0, ps, dim=1)
    valid = allocated & (idx[None, :] <= position[:, None])
    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., L] -> [..., L, L] where out[i,j] = sum_{j<k<=i} x[k], -inf
    above the diagonal (diagonal itself 0); ``repro/models/mamba.py:21``."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full_like(out, -math.inf))


def ssd_scan_ref(x, a, b, c, chunk: int, initial_state=None):
    """Chunked SSD in its matmul form, with the arithmetic and the dtype
    casts of the reference model's ``ssd_chunked``
    (``repro/models/mamba.py:31-80``): the decays are fp32, and L, the
    per-chunk states and the chunk decays are cast to x's dtype before
    their products, as the reference's model path does (B5 keeps them in
    fp32). x [B,S,H,P] (pre-multiplied by dt), a [B,S,H] (log-decay
    increments, <= 0), b/c [B,S,N] (one group shared by all heads) ->
    (y [B,S,H,P], final_state [B,H,P,N]) in x's dtype."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    bc = b.reshape(B, nc, chunk, N)
    cc = c.reshape(B, nc, chunk, N)
    ac = a.reshape(B, nc, chunk, H).permute(0, 3, 1, 2).float()  # [B,H,nc,l]
    a_cum = torch.cumsum(ac, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(ac)).to(x.dtype)                      # [B,H,nc,l,l]
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * L, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).to(x.dtype)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # 3. inter-chunk recurrence (matmul form over the chunk axis)
    if initial_state is None:
        initial_state = torch.zeros((B, H, P, N), dtype=x.dtype,
                                    device=x.device)
    chunk_decay = a_cum[..., -1]                               # [B,H,nc]
    padded = torch.nn.functional.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(segsum(padded)).to(x.dtype)        # [B,H,nc+1,nc+1]
    states_cat = torch.cat([initial_state[:, None], states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states_cat)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output within each chunk
    state_decay_out = torch.exp(a_cum).to(x.dtype)             # [B,H,nc,l]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states,
                         state_decay_out)
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, final_state


def ssd_sequential_ref(x, a, b, c):
    """The step-by-step SSD recurrence, the strongest oracle
    (``repro/kernels/ref.py:53``): fp32 state, y and the final state cast
    to x's dtype. Shapes as :func:`ssd_scan_ref`."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(a[:, t].float())                        # [B,H]
        upd = x[:, t].float()[..., None] * b[:, t].float()[:, None, None, :]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t].float()))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), state.to(x.dtype)

"""HGNN execution stages (reference semantics, plain PyTorch, float32).

The paper decomposes HGNN execution into FP -> (theta) -> NA -> LSF -> GSF
(Algorithm 2).  Each function here is the counterpart of the one of the
same name in ``repro.core.stages``, with the same layouts:

  * multi-head features are [N, H, Dh]; attention coefficients are [N, H]
  * edge lists are dst-sorted PaddedEdges (src, dst, valid)
  * block-CSR NA takes col_index [R, W] (-1 = padding), masks [R, W, B, B]
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def feature_projection(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """FP stage: h' = x @ W (+ b).  x: [N, Din], w: [Din, H*Dh] -> [N, H*Dh]."""
    h = x @ w
    if b is not None:
        h = h + b
    return h


def attention_coefficients(
    h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex GAT coefficients theta_src[u] = <h'_u, a_src>,
    theta_dst[v] = <h'_v, a_dst>.  h: [N, H, Dh]; a_*: [H, Dh] ->
    ([N, H], [N, H])."""
    th_s = torch.einsum("nhd,hd->nh", h, a_src)
    th_d = torch.einsum("nhd,hd->nh", h, a_dst)
    return th_s, th_d


def _segment_lengths(dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Edges per dst vertex of a dst-sorted edge list: [num_dst].  Every
    entry of ``dst`` must lie in [0, num_dst), so the lengths cover the
    whole list (padding edges sit at num_dst - 1, after the real ones)."""
    bounds = torch.searchsorted(
        dst, torch.arange(num_dst + 1, dtype=dst.dtype, device=dst.device))
    return bounds[1:] - bounds[:-1]


def _segment_sum(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True)


def segment_softmax_aggregate(
    src: torch.Tensor,        # int32 [E]  dst-sorted
    dst: torch.Tensor,        # int32 [E]
    valid: torch.Tensor,      # bool  [E]
    theta_src: torch.Tensor,  # [Ns, H]
    theta_dst: torch.Tensor,  # [Nd, H]
    h_src: torch.Tensor,      # [Ns, H, Dh]
    num_dst: int,
    *,
    leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """NA stage reference: two-pass segment softmax attention aggregation.

    z_v = sum_u softmax_u(LeakyReLU(theta_dst[v] + theta_src[u] + bias)) h'_u

    The edge list must be dst-sorted (``graphs.to_padded_edges`` makes it
    so): each dst vertex's edges are one contiguous segment, reduced by
    ``torch.segment_reduce`` in edge order, so the forward uses no float
    atomics and is deterministic on the card.  The max that stabilises the
    softmax is detached: the result does not depend on it.  The backward
    is plain autograd (its gathers' gradients scatter with atomics); no
    launcher path trains through this function.
    Returns [Nd, H, Dh]."""
    pre = theta_dst[dst] + theta_src[src] + edge_bias
    logits = torch.where(pre >= 0, pre, leaky_slope * pre)
    logits = torch.where(valid[:, None], logits, NEG_INF)
    lengths = _segment_lengths(dst, num_dst)
    m = torch.segment_reduce(logits.detach(), "max", lengths=lengths, axis=0, unsafe=True,
                             initial=NEG_INF)  # [Nd, H]; isolated vertices keep -1e30
    p = torch.where(valid[:, None], torch.exp(logits - m[dst]), 0.0)
    denom = _segment_sum(p, lengths)  # [Nd, H]
    num = _segment_sum(p[:, :, None] * h_src[src], lengths)
    return num / denom.clamp(min=1e-9)[:, :, None]


def segment_mean_aggregate(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    h_src: torch.Tensor,
    num_dst: int,
) -> torch.Tensor:
    """R-GCN NA: z_v = (1/|N_v|) sum_{u in N_v} h'_u.  h_src [Ns, ...].
    A segmented sum over the dst-sorted edge list, as
    :func:`segment_softmax_aggregate` (no float atomics in the forward;
    plain autograd backward)."""
    w = valid.to(h_src.dtype)
    lengths = _segment_lengths(dst, num_dst)
    deg = _segment_sum(w, lengths)
    shape = (-1,) + (1,) * (h_src.dim() - 1)
    num = _segment_sum(h_src[src] * w.reshape(shape), lengths)
    return num / deg.clamp(min=1.0).reshape(shape)


def block_softmax_aggregate(
    col_index: torch.Tensor,   # int32 [R, W]   (-1 = padding)
    masks: torch.Tensor,       # bool  [R, W, B, B]
    theta_src: torch.Tensor,   # [Ns_pad, H]
    theta_dst: torch.Tensor,   # [Nd_pad, H]
    h_src: torch.Tensor,       # [Ns_pad, H, Dh]
    *,
    leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Block-CSR *online-softmax* NA — the paper's softmax decomposition
    (numerator and denominator accumulated together, Fig. 6), all rows at
    once, one block slot at a time, with float32 carries.  The BLOCK
    oracle.  Returns [Nd_pad, H, Dh]."""
    R, W = col_index.shape
    B = masks.shape[-1]
    H, Dh = theta_src.shape[1], h_src.shape[-1]
    dev = h_src.device
    th_d = theta_dst.reshape(R, B, H).float()
    m_run = torch.full((R, B, H), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((R, B, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((R, B, H, Dh), dtype=torch.float32, device=dev)
    lanes = torch.arange(B, device=dev)
    for w in range(W):
        c = col_index[:, w].long()
        src = (c.clamp(min=0)[:, None] * B + lanes).reshape(-1)  # [R*B]
        th_s = theta_src[src].reshape(R, B, H).float()
        hs = h_src[src].reshape(R, B, H, Dh).float()
        pre = th_d[:, :, None, :] + th_s[:, None, :, :] + edge_bias  # [R, Bd, Bs, H]
        logits = torch.where(pre >= 0, pre, leaky_slope * pre)
        live = (masks[:, w] & (c >= 0)[:, None, None])[..., None]
        logits = torch.where(live, logits, NEG_INF)
        m_new = torch.maximum(m_run, logits.amax(dim=2))
        scale = torch.exp(m_run - m_new)
        p = torch.where(live, torch.exp(logits - m_new[:, :, None, :]), 0.0)
        l_run = l_run * scale + p.sum(dim=2)
        acc = acc * scale[..., None] + torch.einsum("rdsh,rshf->rdhf", p, hs)
        m_run = m_new
    out = acc / l_run.clamp(min=1e-9)[..., None]
    return out.reshape(R * B, H, Dh).to(h_src.dtype)


def local_semantic_fusion(
    z: torch.Tensor, w_g: torch.Tensor, b_g: torch.Tensor, q: torch.Tensor, valid_dst: torch.Tensor
) -> torch.Tensor:
    """LSF stage (paper Alg. 2 line 21): partial semantic importance
    w_P = (1/|V|) sum_v q^T tanh(W_g z_v + b).
    z: [Nd, D]; w_g: [D, Da]; q: [Da]; valid_dst: [Nd] -> scalar."""
    s = torch.tanh(z @ w_g + b_g) @ q  # [Nd]
    s = torch.where(valid_dst, s, 0.0)
    return s.sum() / valid_dst.sum().clamp(min=1).to(s.dtype)


def global_semantic_fusion(
    w_p: torch.Tensor, z_stack: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """GSF stage: beta = softmax_P(w_P); h_v = sum_P beta_P z_v^P.
    w_p: [P]; z_stack: [P, Nd, D] -> ([Nd, D], beta [P])."""
    beta = torch.softmax(w_p, dim=0)
    return torch.einsum("p,pnd->nd", beta, z_stack), beta

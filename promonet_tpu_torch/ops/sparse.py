"""PPG sparsification (counterpart of `promonet_tpu/ops/sparse.py`)

PPGs have shape (..., C, T): a distribution over C phonemes per frame.
"""
import torch


def quantile(x, q, dim):
    """Linear-interpolation quantile along `dim`, keeping the dim

    Written out rather than `torch.quantile(..., interpolation='linear')`
    because the two round differently: torch computes
    low + q' * (high - low) while `jnp.quantile` computes
    low * (1 - q') + high * q', which XLA contracts into one fused
    multiply-add (emulated here in float64, exact for float32 products).
    The sparsity mask compares every probability against this cutoff
    with `>=`, so one rounding step decides whether a tied probability
    survives.
    """
    ordered = torch.sort(x, dim=dim).values
    position = torch.tensor(q, dtype=torch.float32) * (x.shape[dim] - 1)
    low = torch.floor(position)
    high_weight = position - low
    low_weight = 1 - high_weight
    low_index = int(low)
    high_index = min(int(torch.ceil(position)), x.shape[dim] - 1)
    low_value = ordered.narrow(dim, low_index, 1)
    high_value = ordered.narrow(dim, high_index, 1)
    high_term = (high_value * high_weight.to(x.dtype)).double()
    return (low_value.double() * low_weight.double() + high_term).to(x.dtype)


def sparsify(ppg, method='percentile', threshold=0.85):
    """Zero small probabilities per frame and renormalize

    Methods
        constant: zero probabilities below `threshold`
        percentile: per-frame threshold at quantile `threshold`
        topk: keep the `threshold` largest probabilities per frame
    """
    if method is None:
        return ppg
    if method == 'constant':
        mask = ppg >= threshold
    elif method == 'percentile':
        mask = ppg >= quantile(ppg, threshold, dim=-2)
    elif method == 'topk':
        kth = torch.sort(ppg, dim=-2).values.narrow(
            -2, ppg.shape[-2] - int(threshold), 1)
        mask = ppg >= kth
    else:
        raise ValueError(f'Sparsification method {method} is not defined')
    sparse = torch.where(mask, ppg, torch.zeros_like(ppg))
    total = torch.clamp(sparse.sum(dim=-2, keepdim=True), min=1e-8)
    return sparse / total


def jensen_shannon(p, q, dim=-2, eps=1e-8):
    """Jensen-Shannon distance between per-frame distributions, in [0, 1]

    Base-2 logs, so the largest divergence is 1; the square root of the
    divergence, clipped to [0, 1], is returned (a metric). p and q are
    normalised along `dim` first.
    """
    p = p / torch.clamp(p.sum(dim=dim, keepdim=True), min=eps)
    q = q / torch.clamp(q.sum(dim=dim, keepdim=True), min=eps)
    m = 0.5 * (p + q)

    def kl(a, b):
        return torch.sum(
            torch.where(
                a > 0, a * (torch.log2(a + eps) - torch.log2(b + eps)),
                torch.zeros((), dtype=a.dtype, device=a.device)),
            dim=dim)

    jsd = 0.5 * kl(p, m) + 0.5 * kl(q, m)
    return torch.sqrt(torch.clamp(jsd, 0., 1.))

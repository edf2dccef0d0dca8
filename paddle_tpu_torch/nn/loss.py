"""Loss functions (counterparts of ``paddle_tpu/nn/functional/loss.py``
``binary_cross_entropy`` (:92) to ``edit_distance`` (:605)), in plain
PyTorch.

None of them reaches a Pallas kernel in the JAX package, so each is tensor
code on its inputs' device, with JAX's defaults, reductions (``"mean"``,
``"sum"``, anything else: no reduction) and order of operations. Where
JAX's formula has a quirk, the port keeps it: ``ctc_loss`` takes logits
``[T, B, C]`` and applies the log-softmax itself, and with a label of
length 0 adds its two end states, as the JAX recursion does (so it is not
``F.ctc_loss``); its ``"mean"`` divides each loss by its label length;
``multi_margin_loss`` keeps the reference's ``margin ** p / C`` term;
``rnnt_loss``'s FastEmit leaves the value as it is and scales the
gradient of the label emissions by ``1 + lambda``. ``edit_distance`` is a
metric: it runs on the host and returns ``(distance [B, 1] f32,
sequence_num)`` on the input's device. ``cross_entropy`` and
``softmax_with_cross_entropy`` live in ``nn/functional.py``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as tF

__all__ = [
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "l1_loss", "nll_loss", "kl_div", "smooth_l1_loss", "margin_ranking_loss",
    "cosine_embedding_loss", "hinge_embedding_loss", "log_loss",
    "square_error_cost", "triplet_margin_loss", "sigmoid_focal_loss",
    "dice_loss", "ctc_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss", "npair_loss",
    "multi_margin_loss", "gaussian_nll_loss",
    "triplet_margin_with_distance_loss", "margin_cross_entropy",
    "hsigmoid_loss", "rnnt_loss", "edit_distance",
]

_NEG_INF = -1e30


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _like(label, ref):
    """``label`` as a tensor on ``ref``'s device (a numpy array or a number
    is taken as it is, like JAX's ``as_tensor``)."""
    if not isinstance(label, torch.Tensor):
        label = torch.as_tensor(np.asarray(label))
    return label.to(ref.device)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    xs = input.float().clamp(1e-12, 1.0 - 1e-7)
    y = _like(label, input)
    out = -(y * torch.log(xs) + (1 - y) * torch.log1p(-xs))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    x = logit.float()
    y = _like(label, logit).float()
    log_sig, log_1msig = tF.logsigmoid(x), tF.logsigmoid(-x)
    if pos_weight is not None:
        pw = _like(pos_weight, logit)
        out = -(pw * y * log_sig + (1 - y) * log_1msig)
    else:
        out = -(y * log_sig + (1 - y) * log_1msig)
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - _like(label, input)).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - _like(label, input)).abs(), reduction)


def square_error_cost(input, label, name=None):
    return (input - _like(label, input)).square()


def log_loss(input, label, epsilon=1e-4, name=None):
    y = _like(label, input)
    return -(y * torch.log(input + epsilon)
             + (1 - y) * torch.log(1 - input + epsilon))


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lbl = _like(label, input).long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    cw = _like(weight, input).to(input.dtype)[safe] if weight is not None \
        else valid.to(input.dtype)
    loss = torch.where(valid, loss * cw, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / (cw * valid).sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    y = _like(label, input)
    if log_target:
        out = torch.exp(y) * (y - input)
    else:
        out = y * (torch.log(y.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - _like(label, input)
    ad = d.abs()
    out = torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    y = _like(label, input)
    return _reduce((-y * (input - other) + margin).clamp_min(0.0),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    y = _like(label, input1)
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.norm(input1, dim=-1)
        * torch.linalg.norm(input2, dim=-1)).clamp_min(1e-12)
    out = torch.where(y == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(out, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    y = _like(label, input)
    out = torch.where(y == 1, input, (margin - input).clamp_min(0.0))
    return _reduce(out, reduction)


def _pnorm(x, p):
    """``jnp.linalg.norm(x, ord=p, axis=-1)`` of a vector batch."""
    if p == 2:
        return torch.linalg.norm(x, dim=-1)
    if p == 1:
        return x.abs().sum(-1)
    if math.isinf(p):
        return x.abs().amax(-1)
    return x.abs().pow(p).sum(-1).pow(1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _pnorm(input - positive + epsilon, p)
    dn = _pnorm(input - negative + epsilon, p)
    if swap:
        dn = torch.minimum(dn, _pnorm(positive - negative + epsilon, p))
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x = logit.float()
    y = _like(label, logit)
    p = torch.sigmoid(x)
    ce = -(y * tF.logsigmoid(x) + (1 - y) * tF.logsigmoid(-x))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    out = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        out = out / _like(normalizer, logit)
    return _reduce(out, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    lbl = _like(label, input)
    n_class = input.shape[-1]
    oh = (lbl.squeeze(-1)[..., None]
          == torch.arange(n_class, device=input.device)).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dims)
    union = input.sum(dims) + oh.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    y = _like(label, input)
    if log_input:
        out = torch.exp(input) - y * input
    else:
        out = input - y * torch.log(input + epsilon)
    if full:
        stirling = y * torch.log(y + epsilon) - y + 0.5 * torch.log(
            2 * math.pi * (y + epsilon))
        out = out + torch.where(y > 1, stirling, torch.zeros_like(stirling))
    return _reduce(out, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    y = _like(label, input)
    out = -(y * tF.logsigmoid(input) + (1 - y) * tF.logsigmoid(-input))
    out = out.mean(-1)
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    y = _like(label, input)
    return _reduce(torch.log1p(torch.exp(-y * input)), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space over ``log_probs [T, B, C]``
    (logits, Paddle's layout; the log-softmax is taken here), JAX's
    recursion step for step (``loss.py:284-335``)."""
    lbl = _like(labels, log_probs).long()
    in_len = _like(input_lengths, log_probs).long()
    lb_len = _like(label_lengths, log_probs).long()
    lp = torch.log_softmax(log_probs.float(), -1)
    t_max, b, _ = lp.shape
    s_len = 2 * lbl.shape[1] + 1
    dev = lp.device
    ext = torch.full((b, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lbl
    rows = torch.arange(b, device=dev)
    neg = torch.full((b, 1), _NEG_INF, device=dev)
    alpha = torch.full((b, s_len), _NEG_INF, device=dev)
    alpha = torch.cat([lp[0, rows, blank][:, None],
                       lp[0, rows, ext[:, 1]][:, None], alpha[:, 2:]], 1)
    same = torch.cat([torch.zeros(b, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], 1)
    hist = [alpha]
    for t in range(1, t_max):
        a1 = torch.cat([neg, alpha[:, :-1]], 1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], 1)
        a2 = torch.where(same, torch.full_like(a2, _NEG_INF), a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m))
        new = torch.where(m <= _NEG_INF / 2, torch.full_like(new, _NEG_INF),
                          new)
        alpha = new + lp[t].gather(1, ext)
        hist.append(alpha)
    hist = torch.stack(hist)                         # [T, B, S]
    a_final = hist[(in_len - 1).clamp(0, t_max - 1), rows]
    la = a_final[rows, (2 * lb_len).clamp(0, s_len - 1)]
    lb_ = a_final[rows, (2 * lb_len - 1).clamp(0, s_len - 1)]
    m = torch.maximum(la, lb_)
    loss = -(m + torch.log(torch.exp(la - m) + torch.exp(lb_ - m)))
    if reduction == "mean":
        return (loss / lb_len.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: an l2 term on the embeddings plus the soft-label cross
    entropy over the anchor-positive similarities (``loss.py:338-357``)."""
    y = _like(labels, anchor)
    b = y.shape[0]
    y2 = y.reshape(b, 1).expand(b, b)
    soft = (y2 == y2.t()).float()
    soft = soft / soft.sum(1, keepdim=True)
    l2 = (anchor.square().sum(1).mean() + positive.square().sum(1).mean()) \
        * 0.25 * l2_reg
    sim = anchor @ positive.t()
    ce_rows = -(soft * torch.log_softmax(sim.float(), -1)).sum(-1)
    return l2 + ce_rows.mean()


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    n, c = input.shape
    y = _like(label, input).long().reshape(n, 1)
    diff = (margin - input.gather(1, y) + input).clamp_min(0.0)
    if weight is not None:
        wl = _like(weight, input)[y.reshape(n)].reshape(n, 1)
        per = ((wl * diff) ** p).mean(1, keepdim=True) \
            - wl * (margin ** p / c)
    else:
        per = (diff ** p).mean(1, keepdim=True) - margin ** p / c
    return _reduce(per.reshape(n), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    v = _like(variance, input).clamp_min(epsilon)
    out = 0.5 * (torch.log(v) + (input - _like(label, input)).square() / v)
    if full:
        out = out + 0.5 * math.log(2 * math.pi)
    return _reduce(out, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        def distance_function(u, w):
            return (u - w).square().sum(-1).clamp_min(1e-12).sqrt()
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: the target logit ``cos(theta)`` becomes
    ``cos(margin1 * theta + margin2) - margin3`` before the scale. The loss
    is ``[N, 1]`` unreduced (``loss.py:430-466``)."""
    n, c = logits.shape
    y = _like(label, logits).long().reshape(n)
    cos_t = logits.gather(1, y[:, None]).reshape(n).clamp(-1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    oh = tF.one_hot(y, c).to(logits.dtype)
    mod = (logits * (1.0 - oh) + target[:, None] * oh) * scale
    logp = torch.log_softmax(mod.float(), -1)
    loss = -logp.gather(1, y[:, None])
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@functools.lru_cache(maxsize=32)
def _hsigmoid_default_tree(num_classes):
    """``(path_table, path_code, path_mask)`` numpy arrays of the complete
    binary tree over ``num_classes`` leaves (heap numbering: class c's leaf
    is node ``c + num_classes``; internal node k >= 1 owns weight row
    ``k - 1``)."""
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    table = np.zeros((num_classes, depth), np.int64)
    code = np.zeros((num_classes, depth), np.float32)
    mask = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node = c + num_classes
        path = []
        while node > 1:
            path.append((node // 2 - 1, float(node % 2)))
            node //= 2
        for d, (row, bit) in enumerate(reversed(path)):
            table[c, d] = row
            code[c, d] = bit
            mask[c, d] = 1.0
    return table, code, mask


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[N, 1]``: the default tree is the
    complete binary tree over ``num_classes``; a custom tree passes
    ``path_table`` / ``path_code``, negative entries padding short paths
    (``loss.py:491-526``)."""
    dev = input.device
    if path_table is None:
        table, code, mask = (torch.from_numpy(a).to(dev) for a in
                             _hsigmoid_default_tree(num_classes))
    else:
        table = _like(path_table, input).long()
        code = _like(path_code, input).float()
        mask = (table >= 0).float()
        table = table.clamp_min(0)
    y = _like(label, input).long().reshape(-1)
    rows, bits, msk = table[y], code[y], mask[y]
    logit = torch.einsum("ndf,nf->nd", weight[rows].float(), input.float())
    if bias is not None:
        logit = logit + bias.reshape(-1)[rows]
    per = logit.clamp_min(0) - logit * bits \
        + torch.log1p(torch.exp(-logit.abs()))
    return (per * msk).sum(1, keepdim=True)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss by the alpha recursion over the ``[T, U + 1]`` lattice of
    ``input [B, T, U + 1, C]`` logits (``loss.py:529-602``)."""
    lbl = _like(label, input).long()
    in_len = _like(input_lengths, input).long()
    lb_len = _like(label_lengths, input).long()
    lp = torch.log_softmax(input.float(), -1)
    bsz, t_max, u_max, _ = lp.shape
    blank_lp = lp[..., blank]                            # [B, T, U+1]
    y_lp = lp[:, :, :-1, :].gather(
        -1, lbl[:, None, :, None].expand(bsz, t_max, u_max - 1, 1))[..., 0]
    if fastemit_lambda:
        y_lp = (1.0 + fastemit_lambda) * y_lp \
            - fastemit_lambda * y_lp.detach()

    def lse(a, b):
        m = torch.maximum(a, b)
        out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
        return torch.where(m <= _NEG_INF / 2, torch.full_like(out, _NEG_INF),
                           out)

    row = [torch.zeros(bsz, device=lp.device)]
    for u in range(1, u_max):
        row.append(row[-1] + y_lp[:, 0, u - 1])
    rows = [torch.stack(row, 1)]
    for t in range(1, t_max):
        from_blank = rows[-1] + blank_lp[:, t - 1, :]
        cur = [from_blank[:, 0]]
        for u in range(1, u_max):
            cur.append(lse(from_blank[:, u], cur[-1] + y_lp[:, t, u - 1]))
        rows.append(torch.stack(cur, 1))
    hist = torch.stack(rows)                             # [T, B, U+1]
    t_fin = (in_len - 1).clamp(0, t_max - 1)
    u_fin = lb_len.clamp(0, u_max - 1)
    b_idx = torch.arange(bsz, device=lp.device)
    loss = -(hist[t_fin, b_idx, u_fin] + blank_lp[b_idx, t_fin, u_fin])
    return _reduce(loss, reduction)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance a batch row, ``(distance [B, 1] f32,
    sequence_num)``, computed on the host as JAX's recursion does it (a
    row past the input's length and a column past the label's are frozen;
    ``ignored_tokens`` are dropped first); not differentiable."""
    dev = input.device if isinstance(input, torch.Tensor) else None
    a = np.asarray(torch.as_tensor(input).cpu(), np.int64)
    b = np.asarray(torch.as_tensor(label).cpu(), np.int64)
    bsz, ta = a.shape
    tb = b.shape[1]
    a_len = np.full(bsz, ta) if input_length is None else \
        np.asarray(torch.as_tensor(input_length).cpu(), np.int64)
    b_len = np.full(bsz, tb) if label_length is None else \
        np.asarray(torch.as_tensor(label_length).cpu(), np.int64)
    if ignored_tokens:
        def compact(seq, n):
            keep = ~np.isin(seq, list(ignored_tokens))
            order = np.argsort(~keep, kind="stable")
            return seq[order], int((keep & (np.arange(len(seq)) < n)).sum())
        a, a_len = map(np.array, zip(*(compact(s, n)
                                       for s, n in zip(a, a_len))))
        b, b_len = map(np.array, zip(*(compact(s, n)
                                       for s, n in zip(b, b_len))))
    dist = np.zeros(bsz, np.float32)
    for r in range(bsz):
        la, lb = int(a_len[r]), int(b_len[r])
        prev = np.minimum(np.arange(tb + 1), lb).astype(np.float32)
        for i in range(ta):
            if i >= la:
                continue
            new = np.empty(tb + 1, np.float32)
            new[0] = carry = np.float32(i + 1)
            for j in range(tb):
                sub = prev[j] + (0.0 if a[r, i] == b[r, j] else 1.0)
                cur = min(prev[j + 1] + 1.0, carry + 1.0, sub)
                carry = cur if j < lb else carry
                new[j + 1] = carry
            prev = new
        dist[r] = prev[min(max(lb, 0), tb)]
    if normalized:
        dist = dist / np.maximum(b_len.astype(np.float32), 1.0)
    return (torch.from_numpy(dist.reshape(bsz, 1)).to(dev),
            torch.tensor(bsz, dtype=torch.int64, device=dev))

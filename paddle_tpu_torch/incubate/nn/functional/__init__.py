"""Fused functional ops of ``incubate.nn`` (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``).

Three run through kernels, forward and backward:

- ``fused_bias_dropout_residual_layer_norm`` (:12-61): ``(x + bias) *
  mask + residual`` then layer norm, through
  ``ops/kernels/bias_dropout_ln.py``; the f32 dropout mask (``keep / (1 -
  p)``) is drawn on x's device from the default generator;
- ``fused_dropout_add`` (:153-186): counter-hash dropout of ``x`` plus
  ``y`` through ``ops/kernels/dropout_add.py``, its int32 seed drawn on the
  host;
- ``fused_linear_param_grad_add`` (:189-252): ``dweight += x^T dy`` in
  place through ``ops/kernels/linear_grad_add.py``, the bias sum in plain
  tensor code.

``fused_linear``, ``fused_matmul_bias`` and ``fused_linear_activation``
are ``torch.matmul`` plus bias and activation, as JAX leaves them to XLA.

The attention, FFN and MoE functions are JAX's composites in plain tensor
code on the caller's device, their products ``torch.matmul`` / ``einsum``
(f32 where JAX asks for an f32 result): ``memory_efficient_attention``
(:72), ``fused_ec_moe`` (:278), ``variable_length_memory_efficient_attention``
(:315), ``masked_multihead_attention`` (:369), ``fused_multi_head_attention``
(:433, its attention ``nn.functional.scaled_dot_product_attention``: the
flash kernel with no mask and no attention dropout), ``fused_feedforward``
(:506) and ``fused_gate_attention`` (:543). ``fused_multi_transformer``
(``fused_transformer_serving.py``) decodes through the mmha kernel.
Each kernel function takes ``plain=True`` to run the plain versions on any
device. The dropout draws come from the port's ``torch.Generator`` s
(``core/generator.py``), not ``jax.random``: the same seed gives other
masks than JAX's.
"""

from __future__ import annotations

import torch

from ....core import generator as _gen
from ....nn import functional as F
from ....nn.functional import layer_norm as fused_layer_norm  # noqa: F401
from ....nn.functional import rms_norm as fused_rms_norm  # noqa: F401
from ....nn.functional import rope as fused_rotary_position_embedding  # noqa: F401
from ....nn.functional import \
    scaled_dot_product_attention as fused_dot_product_attention  # noqa: F401
from ....nn.functional import swiglu  # noqa: F401
from ....ops.kernels import bias_dropout_ln as _bdl
from ....ops.kernels import dropout_add as _da
from ....ops.kernels import linear_grad_add as _lga

__all__ = ["fused_bias_dropout_residual_layer_norm", "fused_linear",
           "fused_dropout_add", "fused_linear_param_grad_add",
           "fused_matmul_bias", "fused_linear_activation", "fused_rms_norm",
           "fused_layer_norm", "fused_rotary_position_embedding", "swiglu",
           "fused_dot_product_attention", "memory_efficient_attention",
           "fused_ec_moe", "variable_length_memory_efficient_attention",
           "masked_multihead_attention", "fused_multi_head_attention",
           "fused_feedforward", "fused_gate_attention",
           "fused_multi_transformer"]


def dropout_mask(shape, p: float, device):
    """The f32 dropout mask of ``fused_bias_dropout_residual_layer_norm``:
    ``keep / (1 - p)`` with ``keep`` a Bernoulli(1 - p) draw on ``device``
    from the default generator (JAX draws it at :36-43)."""
    keep = torch.empty(shape, device=device).bernoulli_(
        1.0 - p, generator=_gen.default_generator.generator(device))
    return keep / (1.0 - p)


def dropout_seed() -> int:
    """The int32 seed of one ``fused_dropout_add`` call, drawn on the host
    so that drawing it never waits for the card."""
    return _gen.default_generator.random()


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.0, ln_epsilon=1e-5,
                                           training=True, plain=False):
    """``layer_norm(dropout(x + bias) + residual) * ln_scale + ln_bias``
    through the kernel. The mask is drawn only in training with ``0 <
    dropout_rate < 1``; at ``dropout_rate >= 1`` in training it is zeros;
    otherwise the maskless variant runs. A missing bias, ``ln_scale`` or
    ``ln_bias`` is f32 zeros, ones or zeros (:44-47), and gets no
    gradient."""
    hd = x.shape[-1]
    if training and dropout_rate >= 1.0:
        mask = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    elif training and dropout_rate > 0.0:
        mask = dropout_mask(x.shape, dropout_rate, x.device)
    else:
        mask = None
    zeros = torch.zeros(hd, dtype=torch.float32, device=x.device)
    b = zeros if bias is None else bias
    g = zeros + 1.0 if ln_scale is None else ln_scale
    be = zeros if ln_bias is None else ln_bias
    if F._needs_grad(x, residual, b, g, be):
        return _bdl.BiasDropoutLNFunction.apply(x, b, residual, mask, g, be,
                                                ln_epsilon, plain)[0]
    fn = _bdl.bias_dropout_ln_plain if plain else _bdl.bias_dropout_ln
    return fn(x, b, residual, mask, g, be, ln_epsilon)[0]


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight
    (``[out, in]`` with ``transpose_weight``)."""
    out = torch.matmul(x, weight.t() if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, plain=False):
    """``dropout(x, p) + y``. The kernel runs exactly where JAX's does but
    for size: in training, ``mode == 'upscale_in_train'``, ``x`` and ``y``
    of one shape and dtype, and ``0 < p < 1`` (JAX also asks for 1024
    elements, ``dropout_add_pallas.py:172-175``; the port's kernel takes
    small tensors too). Every other case is JAX's composite,
    ``nn.functional.dropout(x, p, training, mode) + y``."""
    if (training and mode == "upscale_in_train" and x.shape == y.shape
            and x.dtype == y.dtype and 0.0 < p < 1.0):
        seed = dropout_seed()
        if F._needs_grad(x, y):
            return _da.DropoutAddFunction.apply(x, y, seed, float(p), plain)
        fn = _da.dropout_add_plain if plain else _da.dropout_add
        return fn(x, y, seed, float(p))
    return F.dropout(x, p, training=training, mode=mode) + y


def fused_linear_param_grad_add(x, dy, dweight=None, dbias=None,
                                multi_precision=False, has_bias=False,
                                plain=False):
    """Accumulate a linear layer's parameter gradients: ``dweight [K, N] +=
    flatten(x)^T @ flatten(dy)`` through the kernel, and with ``has_bias``
    ``dbias [N] += sum(dy)`` (an f32 sum, cast to the accumulator's dtype).
    The inputs are detached; the function is not differentiable. A
    missing accumulator starts as zeros, f32 under ``multi_precision``,
    else x's dtype. Given accumulators are updated in place (JAX returns
    new arrays). Returns ``(dweight, dbias or None)``."""
    x, dy = x.detach(), dy.detach()
    k, n = x.shape[-1], dy.shape[-1]
    acc_dtype = torch.float32 if multi_precision else x.dtype
    x2, dy2 = x.reshape(-1, k), dy.reshape(-1, n)
    acc = torch.zeros(k, n, dtype=acc_dtype, device=x.device) \
        if dweight is None else dweight.detach()
    fn = _lga.linear_grad_add_plain if plain else _lga.linear_grad_add
    fn(x2, dy2, acc)
    dw = acc if dweight is None else dweight
    if not has_bias:
        return dw, None
    s = dy2.float().sum(0)
    if dbias is None:
        return dw, s.to(acc_dtype)
    db = dbias.detach()
    db.copy_((s + db.float()).to(db.dtype))
    return dw, dbias


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y + bias`` (reference ``fused_matmul_bias.py:21``)."""
    out = torch.matmul(x.transpose(-1, -2) if transpose_x else x,
                       y.transpose(-1, -2) if transpose_y else y)
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation=None):
    """``activation(x @ y + bias)``, activation None, "gelu" (erf form) or
    "relu" (reference ``fused_matmul_bias.py:110``)."""
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation in (None, "", "none"):
        return out
    if activation == "gelu":
        return F.gelu(out)
    if activation == "relu":
        return torch.relu(out)
    raise ValueError(f"unsupported activation {activation!r}")


#: keys a chunk of ``memory_efficient_attention`` (JAX's ``CHUNK``, :89)
_MEA_CHUNK = 512


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """Attention over ``[B, S, H, D]`` with an online softmax over chunks
    of 512 keys (JAX :72-150): q scaled in its dtype, each chunk's scores
    and ``P V`` in f32, a bias broadcast to ``[B, H, Sq, Skv]`` and padded
    with -inf, padded keys masked, the output divided by ``max(l, 1e-30)``
    and cast to q's dtype. ``p`` in training is dropout of the output, as
    JAX applies it (:145-149)."""
    sc = scale if scale is not None else query.shape[-1] ** -0.5
    qt = query.transpose(1, 2) * sc
    kt, vt = key.transpose(1, 2), value.transpose(1, 2)
    b, h, sq, _ = qt.shape
    skv = kt.shape[2]
    n_chunks = max(1, -(-skv // _MEA_CHUNK))
    pad = n_chunks * _MEA_CHUNK - skv
    if pad:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
    bias = None
    if attn_bias is not None:
        bias = torch.nn.functional.pad(
            attn_bias.expand(b, h, sq, skv), (0, pad), value=float("-inf"))
    valid = torch.arange(n_chunks * _MEA_CHUNK, device=qt.device) < skv
    acc = torch.zeros(b, h, sq, vt.shape[-1], dtype=torch.float32,
                      device=qt.device)
    m = torch.full((b, h, sq), float("-inf"), device=qt.device)
    l = torch.zeros(b, h, sq, device=qt.device)
    qf = qt.float()
    for c in range(n_chunks):
        sl = slice(c * _MEA_CHUNK, (c + 1) * _MEA_CHUNK)
        kb, vb = kt[:, :, sl], vt[:, :, sl]
        s = torch.matmul(qf, kb.float().transpose(-1, -2))
        if bias is not None:
            s = s + bias[..., sl].float()
        s = s.masked_fill(~valid[sl], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            pexp.to(vb.dtype).float(), vb.float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).to(query.dtype)
    out = out.transpose(1, 2)
    if p and training:
        out = F.dropout(out, p, training=True)
    return out


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type):
    """Expert-choice MoE FFN (JAX :278-312): ``gate`` holds the routing
    logits ``[B, S, E]``; each expert takes its ``max(1, B*S // E)`` tokens
    of highest softmax score (``topk`` over the transposed scores), runs
    them through ``[E, ...]`` batched products with ``act_type`` "gelu"
    (the tanh form, ``jax.nn.gelu``'s default) or "relu", scales each
    result by its score and adds it back at its token."""
    if act_type not in ("gelu", "relu"):
        raise ValueError(f"unsupported act_type {act_type!r}")
    b, s, h = x.shape
    e = gate.shape[-1]
    cap = max(1, (b * s) // e)
    tokens = x.reshape(b * s, h)
    scores = torch.softmax(gate.reshape(b * s, e), dim=-1)
    gates, idx = torch.topk(scores.t(), cap, dim=-1)          # [E, cap]
    picked = tokens[idx.reshape(-1)].reshape(e, cap, h)
    hmid = torch.bmm(picked, bmm0_weight) + bmm0_bias
    hmid = F.gelu(hmid, approximate=True) if act_type == "gelu" \
        else torch.relu(hmid)
    out_e = (torch.bmm(hmid, bmm1_weight) + bmm1_bias) * gates[..., None]
    flat = torch.zeros(b * s, h, dtype=x.dtype, device=x.device).index_add(
        0, idx.reshape(-1), out_e.reshape(e * cap, h).to(x.dtype))
    return flat.reshape(b, s, h)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False):
    """Attention over padded batches in the ``[B, H, S, D]`` layout (JAX
    :315-366): kv heads repeated (GQA), f32 scores plus ``mask``, keys
    past ``kv_seq_lens[b]`` (and, with ``causal``, after the query) masked;
    a row with no valid key gives zeros, and query rows past
    ``seq_lens[b]`` are zeroed."""
    sc = float(scale) if scale is not None else query.shape[-1] ** -0.5
    hq, hk = query.shape[1], key.shape[1]
    if hq != hk:
        key = key.repeat_interleave(hq // hk, dim=1)
        value = value.repeat_interleave(hq // hk, dim=1)
    s = torch.matmul((query * sc).float(), key.float().transpose(-1, -2))
    if mask is not None:
        s = s + mask.float()
    dev = query.device
    kvlen = kv_seq_lens.reshape(-1).to(dev)
    qlen = seq_lens.reshape(-1).to(dev)
    kidx = torch.arange(key.shape[2], device=dev)
    valid = kidx[None, None, None, :] < kvlen[:, None, None, None]
    if causal:
        valid = valid & (kidx[None, None, None, :]
                         <= torch.arange(query.shape[2],
                                         device=dev)[None, None, :, None])
    any_valid = valid.any(-1, keepdim=True)
    p = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
    p = torch.where(any_valid, p, torch.zeros((), device=dev))
    out = torch.matmul(p.to(value.dtype), value)
    qvalid = torch.arange(query.shape[2], device=dev)[None, None, :, None] \
        < qlen[:, None, None, None]
    return torch.where(qvalid, out, torch.zeros((), dtype=out.dtype,
                                                device=dev))


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype='default', out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One decode step over ``cache_kv [2, B, H, T, D]`` (JAX :369-430):
    ``x [B, 3*H*D]`` (+ ``bias``) gives q, k and v; k and v are written at
    ``sequence_lengths[b]`` (0 without them) of a copy of the cache; the
    f32 scores over positions ``<= pos`` plus ``src_mask`` give the
    output ``[B, H*D]``. Returns ``(out, cache_kv')``, the cache a new
    tensor as JAX's. The quant, beam and rotary arguments raise."""
    if any(a is not None for a in (qkv_out_scale, out_shift, out_smooth,
                                   beam_cache_offset, cum_offsets)) \
            or out_scale != -1 or rotary_emb_dims:
        raise NotImplementedError(
            "quant/beam/rotary arguments of masked_multihead_attention are "
            "not supported on TPU (use weight_only_linear + F.rope)")
    if cache_kv is None:
        raise ValueError("cache_kv is required")
    _, b, h, t, d = cache_kv.shape
    dev = x.device
    qkv = x.reshape(b, 3, h, d)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, h, d)
    qv, kv, vv = qkv[:, 0], qkv[:, 1], qkv[:, 2]               # [B, H, D]
    pos = sequence_lengths.reshape(b).to(device=dev, dtype=torch.long) \
        if sequence_lengths is not None \
        else torch.zeros(b, dtype=torch.long, device=dev)
    bidx = torch.arange(b, device=dev)
    kbuf, vbuf = cache_kv[0].clone(), cache_kv[1].clone()
    kbuf[bidx, :, pos] = kv.to(kbuf.dtype)
    vbuf[bidx, :, pos] = vv.to(vbuf.dtype)
    s = torch.einsum("bhd,bhtd->bht", (qv * d ** -0.5).float(), kbuf.float())
    valid = torch.arange(t, device=dev)[None, None, :] <= pos[:, None, None]
    if src_mask is not None:
        s = s + src_mask.reshape(b, 1, -1)[:, :, :t].float()
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bht,bhtd->bhd", p.to(vbuf.dtype), vbuf)
    return out.reshape(b, h * d), torch.stack([kbuf, vbuf])


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-05, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-05,
                               training=True, mode='upscale_in_train',
                               ring_id=-1, add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None):
    """The fused MHA block (JAX :433-503): [pre-LN ->] qkv projection
    (``qkv_weight [3, H, hd, D]``, or ``[D, 3*D]`` with ``transpose_qkv_wb``
    and ``num_heads``) -> ``scaled_dot_product_attention`` (+ mask,
    attention dropout in training) -> output projection -> dropout ->
    [+ residual] [-> post-LN]. ``cache_kv`` and ``ring_id`` raise, as in
    JAX."""
    if cache_kv is not None or ring_id != -1:
        raise NotImplementedError(
            "fused_multi_head_attention: cache_kv/ring_id are not "
            "supported on TPU (use masked_multihead_attention for decode, "
            "fleet TP layers for tensor parallelism)")
    dmodel = x.shape[-1]
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError("num_heads required with transpose_qkv_wb")
        h, hd = num_heads, dmodel // num_heads
    else:
        _, h, hd, _ = qkv_weight.shape
    residual = out = x
    if pre_layer_norm:
        out = F.layer_norm(out, dmodel, pre_ln_scale, pre_ln_bias,
                           pre_ln_epsilon)
    b, s, _ = out.shape
    if transpose_qkv_wb:
        qkv = torch.matmul(out, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        qkv = qkv.reshape(b, s, 3, h, hd)
    else:
        qkv = torch.einsum("bsd,thkd->bsthk", out, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(1, 1, 3, h, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0)
    out = torch.matmul(attn.reshape(b, s, h * hd), linear_weight)
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, dropout_rate, training=training, mode=mode)
    if add_residual:
        out = out + residual
    if not pre_layer_norm:
        out = F.layer_norm(out, dmodel, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode='upscale_in_train', ring_id=-1,
                      add_residual=True, name=None):
    """The fused FFN block (JAX :506-540): [pre-LN ->] linear1 ->
    activation ("relu" or "gelu", erf form) -> dropout1 -> linear2 ->
    dropout2 [+ residual] [-> post-LN]."""
    dmodel = x.shape[-1]
    residual = out = x
    if pre_layer_norm:
        out = F.layer_norm(out, dmodel, ln1_scale, ln1_bias, ln1_epsilon)
    out = F.linear(out, linear1_weight, linear1_bias)
    out = getattr(F, activation)(out)
    out = F.dropout(out, dropout1_rate, training=training, mode=mode)
    out = F.linear(out, linear2_weight, linear2_bias)
    out = F.dropout(out, dropout2_rate, training=training, mode=mode)
    if add_residual:
        out = out + residual
    if pre_layer_norm:
        return out
    return F.layer_norm(out, dmodel, ln2_scale, ln2_bias, ln2_epsilon)


def fused_gate_attention(query, key=None, query_weight=None, key_weight=None,
                         value_weight=None, qkv_weight=None,
                         gate_linear_weight=None, gate_linear_bias=None,
                         out_linear_weight=None, out_linear_bias=None,
                         nonbatched_bias=None, attn_mask=None,
                         has_gating=True, merge_qkv=True,
                         use_flash_attn=False):
    """AlphaFold-style gated attention over ``query [B, M, S, Dq]`` (JAX
    :543-614): ``merge_qkv`` projects q, k and v with one ``[3, H, hd,
    Dq]`` weight; otherwise ``[D, H, hd]`` weights attend ``query`` over
    ``key``. f32 scores plus ``nonbatched_bias`` and ``attn_mask``; the
    sigmoid gate scales the heads before the output projection."""
    if merge_qkv:
        _, h, hd, _ = qkv_weight.shape
        qkv = torch.einsum("bmsd,thkd->tbmshk", query, qkv_weight)
        qv, kv, vv = qkv[0], qkv[1], qkv[2]              # [B, M, S, H, hd]
    else:
        hd = query_weight.shape[-1]
        qv = torch.einsum("bmsd,dhk->bmshk", query, query_weight)
        kv = torch.einsum("bmsd,dhk->bmshk", key, key_weight)
        vv = torch.einsum("bmsd,dhk->bmshk", key, value_weight)
    s = torch.einsum("bmqhc,bmkhc->bmhqk", (qv * hd ** -0.5).float(),
                     kv.float())
    if nonbatched_bias is not None:
        s = s + nonbatched_bias.float()
    if attn_mask is not None:
        s = s + attn_mask.float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bmhqk,bmkhc->bmqhc", p.to(vv.dtype), vv)
    if has_gating:
        out = out * torch.sigmoid(
            torch.einsum("bmsd,dhc->bmshc", query, gate_linear_weight)
            + gate_linear_bias)
    out = torch.einsum("bmshc,hcd->bmsd", out, out_linear_weight)
    return out if out_linear_bias is None else out + out_linear_bias


from .fused_transformer_serving import fused_multi_transformer  # noqa: E402,F401

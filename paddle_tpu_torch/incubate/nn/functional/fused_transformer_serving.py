"""The serving-path fused transformer stack (counterpart of
``paddle_tpu/incubate/nn/functional/fused_transformer_serving.py``
``fused_multi_transformer``, :81-239).

Each layer is JAX's dataflow in plain tensor code on the caller's device:
[pre-LN ->] the qkv projection (``trans_qkvw``: ``[3, H, hd, E]``, else
``[E, 3, H, hd]``), rotate-half RoPE, attention, the output projection,
dropout, the residual [-> post-LN], then the FFN the same way.

- **Prefill** (no ``time_step``) is the f32 composite of JAX's
  ``_attention`` (:21-64): causal over the live block with the
  ``pre_caches`` prefix fully visible, keys past ``seq_lens`` masked. One
  difference: an ``attn_mask`` given with ``pre_caches`` is added over the
  prefix and live blocks (a mask over the live block alone is padded with
  zeros over the prefix), where JAX replaces it with the causal mask
  (``ADVICE.md``, the reference's defect at :37).
- **Decode** (``time_step`` given) writes this step's k and v into the
  caller's caches at ``time_step`` with a device index (``index_copy_``)
  and attends through the mmha kernel over the caches in place
  (``ops/kernels/mmha.py`` ``mmha_decode_contiguous``, row 1), with
  ``pos`` ``time_step`` broadcast to ``[B]`` on the device: no host sync.
  A shape the kernel does not take raises on the card (JAX's gate sends it
  to its composite).

With ``cache_kvs`` the function returns ``(out, caches)``, ``caches`` the
caller's ``[2, B, H, T, D]`` tensors updated in place (the reference op's
``CacheKVOut`` shares its input; JAX returns new buffers).
"""

from __future__ import annotations

import math

import torch

from ....nn import functional as F
from ....ops.kernels import mmha as _mmha

__all__ = ["fused_multi_transformer"]


def _attention(q, k, v, attn_mask, seq_lens=None, n_pre=0):
    """Prefill attention of ``q [B, S, H, D]`` over ``k``/``v [B, n_pre +
    S, H, D]`` in f32 (JAX's ``_attention`` with ``pos`` None), cast to q's
    dtype."""
    b, s, _, d = q.shape
    t = k.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(d)
    if attn_mask is not None:
        mask = attn_mask.float()
        if n_pre and mask.shape[-1] == s:
            mask = torch.nn.functional.pad(mask, (n_pre, 0))
        logits = logits + mask
    else:
        qpos = torch.arange(s, device=q.device)[:, None] + n_pre
        kpos = torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos), float("-inf"))
    if seq_lens is not None:
        valid_k = torch.arange(t, device=q.device)[None, :] < (
            seq_lens.reshape(b, 1).to(q.device) + n_pre)
        logits = logits.masked_fill(~valid_k[:, None, None, :],
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def _apply_rotary(q, k, cos, sin):
    """Rotate-half RoPE with ``cos``/``sin [B, 1, S, D]`` on ``[B, S, H,
    D]`` (JAX :67-78)."""
    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    c, s = cos.transpose(1, 2), sin.transpose(1, 2)
    return q * c + rot(q) * s, k * c + rot(k) * s


def _decode_pos(time_step, b, device):
    """``time_step`` (an int, or a tensor whose first element it is) as
    int32 ``[B]`` on ``device``, made there."""
    if isinstance(time_step, int):
        return torch.full((b,), time_step, dtype=torch.int32, device=device)
    ts = time_step.reshape(-1)[:1].to(device=device, dtype=torch.int32)
    return ts.expand(b).contiguous()


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, cache_kvs=None, pre_caches=None, seq_lens=None,
        rotary_embs=None, time_step=None, attn_mask=None, dropout_rate=0.0,
        rotary_emb_dims=0, activation="gelu", training=False,
        mode="upscale_in_train", trans_qkvw=True, ring_id=-1, name=None,
        plain=False):
    """An L-layer transformer stack (reference ``fused_transformer.py:973``).
    Returns ``out``, or ``(out, caches)`` with ``cache_kvs`` (the caller's
    tensors, updated in place). ``plain=True`` decodes through
    ``mmha.reference_mmha`` on any device."""
    if time_step is not None and pre_caches is not None:
        raise NotImplementedError(
            "pre_caches with time_step decode is not supported — prefill "
            "with the prefix first, then decode from cache_kvs")
    b, s, d_model = x.shape
    use_cache = cache_kvs is not None
    decode = time_step is not None
    if decode:
        pos = _decode_pos(time_step, b, x.device)
        at = pos[:1].long()

    def act_fn(v):
        return F.gelu(v) if activation == "gelu" else torch.relu(v)

    def maybe_dropout(v):
        if training and dropout_rate > 0.0:
            return F.dropout(v, dropout_rate, training=True, mode=mode)
        if not training and dropout_rate > 0.0 \
                and mode == "downscale_in_infer":
            return v * (1.0 - dropout_rate)
        return v

    out = x
    for i in range(len(qkv_weights)):
        residual = out
        ln_out = F.layer_norm(out, [d_model], ln_scales[i],
                              ln_biases[i] if ln_biases else None,
                              epsilon) if pre_layer_norm else out
        w = qkv_weights[i]
        nh, hd = (w.shape[1], w.shape[2]) if trans_qkvw \
            else (w.shape[2], w.shape[3])
        w2 = w.reshape(3 * nh * hd, d_model).t() if trans_qkvw \
            else w.reshape(d_model, 3 * nh * hd)
        qkv = torch.matmul(ln_out, w2)
        if qkv_biases:
            qkv = qkv + qkv_biases[i].reshape(-1)
        qkv = qkv.reshape(b, s, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rotary_embs is not None and rotary_emb_dims > 0:
            q, k = _apply_rotary(q, k, rotary_embs[0], rotary_embs[1])
        n_pre = 0
        if pre_caches is not None:
            pc = pre_caches[i]                    # [2, B, NH, C, HD]
            n_pre = pc.shape[3]
            k = torch.cat([pc[0].transpose(1, 2).to(k.dtype), k], dim=1)
            v = torch.cat([pc[1].transpose(1, 2).to(v.dtype), v], dim=1)
        if not use_cache:
            att = _attention(q, k, v, attn_mask, seq_lens, n_pre)
        else:
            kbuf, vbuf = cache_kvs[i][0], cache_kvs[i][1]  # [B, NH, T, HD]
            if decode:
                kbuf.index_copy_(2, at, k.transpose(1, 2).to(kbuf.dtype))
                vbuf.index_copy_(2, at, v.transpose(1, 2).to(vbuf.dtype))
                fn = _mmha.reference_mmha if plain \
                    else _mmha.mmha_decode_contiguous
                att = fn(q.contiguous(), kbuf, vbuf, pos)
            else:
                n = k.shape[1]
                kbuf[:, :, :n].copy_(k.transpose(1, 2))
                vbuf[:, :, :n].copy_(v.transpose(1, 2))
                att = _attention(q, k, v, attn_mask, seq_lens, n_pre)
        att_out = torch.matmul(att.reshape(b, s, nh * hd), linear_weights[i])
        if linear_biases:
            att_out = att_out + linear_biases[i]
        out = residual + maybe_dropout(att_out)
        if not pre_layer_norm:
            out = F.layer_norm(out, [d_model], ln_scales[i],
                               ln_biases[i] if ln_biases else None, epsilon)

        ffn_residual = out
        ffn_in = F.layer_norm(out, [d_model], ffn_ln_scales[i],
                              ffn_ln_biases[i] if ffn_ln_biases else None,
                              epsilon) if pre_layer_norm else out
        h1 = torch.matmul(ffn_in, ffn1_weights[i])
        if ffn1_biases:
            h1 = h1 + ffn1_biases[i]
        h1 = maybe_dropout(act_fn(h1))
        h2 = torch.matmul(h1, ffn2_weights[i])
        if ffn2_biases:
            h2 = h2 + ffn2_biases[i]
        out = ffn_residual + maybe_dropout(h2)
        if not pre_layer_norm:
            out = F.layer_norm(out, [d_model], ffn_ln_scales[i],
                               ffn_ln_biases[i] if ffn_ln_biases else None,
                               epsilon)
    if use_cache:
        return out, list(cache_kvs)
    return out

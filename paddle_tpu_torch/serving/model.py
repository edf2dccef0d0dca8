"""Serving adapter: a Llama over the paged KV cache (counterpart of
``paddle_tpu/serving/model.py``).

``prefill_forward`` runs a whole prompt and writes its pages;
``prefill_chunk_forward`` runs one chunk of a request's context against
what is already resident; ``decode_forward`` runs one token per batch row;
``verify_forward`` runs the K + 1 lanes of a speculative verify step per
batch row.

Two dataflows, picked by ``fused_block`` alone (never by the device):

- ``fused_block=True`` (the default, as in the JAX engine): layer 0's
  input norm is an RMSNorm; after that every residual junction —
  attention output -> ``post_attention_layernorm`` and MLP output -> the
  next layer's ``input_layernorm`` (the final norm after the last layer) —
  is one block-epilogue pass that returns the normed input of the next
  op and the residual stream, and the lm head reads the normed state.
- ``fused_block=False``: the per-op chain, RMSNorm, then after attention
  the fused residual-add RMSNorm and a separate residual add after the
  MLP, and the head's own final norm.

In both, RoPE, SwiGLU, decode attention (mmha), the norms and, in
monolithic prefill, attention (flash) are the port's kernels; the
projections, the embedding lookup and the chunk attention are plain
PyTorch, as the JAX package leaves them to XLA. ``plain=True`` runs every
kernel's plain PyTorch version instead (a check on the card holds the two
paths against each other on the same inputs).

``fused_decode_layer=True`` (with ``fused_block`` and bias-free o/gate/up/
down projections, the JAX gate at ``paddle_tpu/serving/model.py:95-107``)
sends each decode step through the decode-layer kernel: per layer, QKV,
RoPE and the KV writes as before, then one ``decode_layer`` launch from the
attention to the next layer's normed input. Prefill, chunks and every
other path are unchanged; the speculative verify runs the layer loop.

``quant`` (None | "weight_only_int8" | "weight_only_int4" | "int8" |
"int4", the JAX names, ``paddle_tpu/serving/model.py:31-40``) quantizes
every decoder-layer linear (q, k, v, o, gate, up, down) once at
construction, from ``linear.weight.t()`` (``[in, out]``, the JAX layout),
per channel or in groups of ``quant_group_size`` along K; each of those
projections then runs through the weight-only kernels
(``nn.quant.weight_only_linear``) in every forward. The lm head and the
embeddings stay float. With ``fused_decode_layer`` the decode-layer kernel
is fed the quantized values of o/gate/up/down dequantized once at
construction (the JAX rule, ``:129-140``), in the model's dtype and
``[out, in]`` layout; q/k/v keep the weight-only kernels.
"""

from __future__ import annotations

import os

import torch

from ..nn import functional as F
from ..nn.quant import weight_dequantize, weight_only_linear, weight_quantize
from ..ops.kernels import block_epilogue, decode_layer
from . import kv_cache

__all__ = ["ServingModel"]

_QUANT_ALGOS = {"weight_only_int8": "int8", "weight_only_int4": "int4",
                "int8": "int8", "int4": "int4"}

#: (tag, block, linear) per decoder layer: the linears the quant path swaps
_LAYER_LINEARS = (
    ("q", "self_attn", "q_proj"), ("k", "self_attn", "k_proj"),
    ("v", "self_attn", "v_proj"), ("o", "self_attn", "o_proj"),
    ("gate", "mlp", "gate_proj"), ("up", "mlp", "up_proj"),
    ("down", "mlp", "down_proj"),
)


class ServingModel:
    """Prefill, prefill-chunk and decode forwards of a port :class:`Llama`
    (or dense :class:`~..models.ernie.Ernie`, a Llama with ERNIE's widths
    and a tied head) over a bound :class:`~.kv_cache.PagePool`. A model
    with a routed MoE layer raises ``TypeError``."""

    def __init__(self, model, quant: str | None = None,
                 quant_group_size: int = -1, fused_block: bool = True,
                 fused_decode_layer: bool = False):
        missing = [n for n in ("embed_tokens", "layers", "norm", "cfg")
                   if getattr(model, n, None) is None]
        if missing:
            raise TypeError(f"ServingModel needs a Llama-family module "
                            f"layout; {type(model).__name__} is missing: "
                            f"{', '.join(missing)}")
        from ..incubate.distributed.models.moe import MoELayer
        moe = next((i for i, layer in enumerate(model.layers)
                    if isinstance(getattr(layer, "mlp", None), MoELayer)),
                   None)
        if moe is not None:
            # the JAX adapter reaches mlp.gate_proj (paddle_tpu/serving/
            # model.py:186-192), which a routed MoE block does not have
            raise TypeError(f"ServingModel serves dense decoder layers; "
                            f"{type(model).__name__}'s layers.{moe}.mlp is a "
                            f"routed MoELayer (serve a dense model, or call "
                            f"generate(), which takes the exact-length host "
                            f"loop)")
        self.model = model
        self.cfg = cfg = model.cfg
        self.n_head = cfg.num_heads
        self.n_kv = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.max_pos = cfg.max_position_embeddings
        self.fused_block = bool(fused_block)
        # the decode-layer kernel folds o/gate/up/down whole: it needs the
        # fused dataflow and bias-free projections
        self.fused_decode_layer = bool(fused_decode_layer) and \
            self.fused_block and all(
                getattr(mod, "bias", None) is None
                for layer in model.layers
                for mod in (layer.self_attn.o_proj, layer.mlp.gate_proj,
                            layer.mlp.up_proj, layer.mlp.down_proj))
        self.pool: kv_cache.PagePool | None = None
        self._quant_dtype = None
        self._qweights: dict = {}
        self._dq_weights: dict = {}
        if quant:
            self._quantize(quant, quant_group_size)

    @torch.no_grad()
    def _quantize(self, quant, group_size):
        """Quantize every decoder-layer linear once; on a fused-layer model
        also dequantize o/gate/up/down once for the decode-layer kernel."""
        if quant not in _QUANT_ALGOS:
            raise ValueError(f"quant must be one of {sorted(_QUANT_ALGOS)}, "
                             f"got {quant!r}")
        algo = quant if quant.startswith("weight_only_") else \
            "weight_only_" + quant
        self._quant_dtype = _QUANT_ALGOS[quant]
        for i, layer in enumerate(self.model.layers):
            for tag, block, name in _LAYER_LINEARS:
                mod = getattr(getattr(layer, block), name)
                self._qweights[(tag, i)] = weight_quantize(
                    mod.weight.t(), algo=algo, group_size=group_size)
                if self.fused_decode_layer and tag in ("o", "gate", "up",
                                                       "down"):
                    # the decode-layer kernel reads dense [out, in] weights
                    # in the model's dtype: the quantized values, rounded
                    # once to that dtype (the JAX engine keeps them in f32)
                    self._dq_weights[(tag, i)] = weight_dequantize(
                        *self._qweights[(tag, i)], algo=algo).t().to(
                            mod.weight.dtype).contiguous()

    @property
    def quantized(self) -> bool:
        return bool(self._qweights)

    def bind_pool(self, pool: kv_cache.PagePool) -> "ServingModel":
        if (pool.num_layers, pool.num_kv_heads, pool.head_dim) != \
                (len(self.model.layers), self.n_kv, self.head_dim):
            raise ValueError(
                f"pool shape (layers={pool.num_layers}, "
                f"kv={pool.num_kv_heads}, d={pool.head_dim}) does not "
                f"match model (layers={len(self.model.layers)}, "
                f"kv={self.n_kv}, d={self.head_dim})")
        self.pool = pool
        return self

    # -- shared pieces -------------------------------------------------------

    @staticmethod
    def _junction(x, residual, norm_mod, plain):
        """``(normed, h)``: one residual junction (projection output ->
        residual add -> rmsnorm) as one block-epilogue pass."""
        return block_epilogue.decode_epilogue(x, residual, norm_mod.weight,
                                              norm_mod.eps, plain=plain)

    def _linear(self, tag, i, x, module, plain):
        """One decoder-layer projection: the float ``nn.Linear``, or the
        weight-only kernel on its quantized weight."""
        q = self._qweights.get((tag, i))
        if q is None:
            return module(x)
        qw, scale = q
        return weight_only_linear(x, qw, bias=module.bias, weight_scale=scale,
                                  weight_dtype=self._quant_dtype, plain=plain)

    def _qkv(self, i, layer, h, plain):
        attn = layer.self_attn
        if not self._qweights:
            return attn.qkv(h)
        b, s, _ = h.shape
        return (self._linear("q", i, h, attn.q_proj, plain)
                .reshape(b, s, self.n_head, self.head_dim),
                self._linear("k", i, h, attn.k_proj, plain)
                .reshape(b, s, self.n_kv, self.head_dim),
                self._linear("v", i, h, attn.v_proj, plain)
                .reshape(b, s, self.n_kv, self.head_dim))

    def _mlp(self, i, mlp, y, plain):
        """The SwiGLU MLP; quantized, gate and up through the weight-only
        kernel, the SwiGLU kernel between them and down
        (``paddle_tpu/serving/model.py:186-192``)."""
        if not self._qweights:
            return mlp(y, plain)
        g = self._linear("gate", i, y, mlp.gate_proj, plain)
        u = self._linear("up", i, y, mlp.up_proj, plain)
        return self._linear("down", i, F.swiglu(g, u, plain=plain),
                            mlp.down_proj, plain)

    def _layer_mats(self, i, layer):
        """(wo, wg, wu, wd) the decode-layer kernel folds: the dequantized
        copies on a quant model."""
        dq, mlp = self._dq_weights, layer.mlp
        return (dq.get(("o", i), layer.self_attn.o_proj.weight),
                dq.get(("gate", i), mlp.gate_proj.weight),
                dq.get(("up", i), mlp.up_proj.weight),
                dq.get(("down", i), mlp.down_proj.weight))

    def _head_normed(self, x):
        """lm head over an already normalized hidden state."""
        m = self.model
        if m.lm_head is None:
            return x @ m.embed_tokens.weight.t()
        return m.lm_head(x)

    def _layers(self, x, cos, sin, write_kv, attend, plain):
        """The decoder stack over ``x [B, S, hidden]``; ``write_kv(i, k, v)``
        stores the layer's keys and values in the pool and
        ``attend(i, q, k, v)`` returns its attention ``[B, S, H, D]``.
        Returns the final hidden state: normed on the fused path, pre-norm
        on the per-op path (see :meth:`_logits`)."""
        b, s, _ = x.shape
        layers = list(self.model.layers)
        fused = self.fused_block
        hres = x
        y = layers[0].input_layernorm(x, plain) if fused else None
        for i, layer in enumerate(layers):
            h = y if fused else layer.input_layernorm(x, plain)
            q, k, v = self._qkv(i, layer, h, plain)
            q, k = F.rope(q, k, sin, cos, plain=plain)
            write_kv(i, k, v)
            out = attend(i, q, k, v)
            attn_out = self._linear(
                "o", i, out.reshape(b, s, self.n_head * self.head_dim),
                layer.self_attn.o_proj, plain)
            post = layer.post_attention_layernorm
            if fused:
                y, hres = self._junction(attn_out, hres, post, plain)
                nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) \
                    else self.model.norm
                y, hres = self._junction(self._mlp(i, layer.mlp, y, plain),
                                         hres, nxt, plain)
            else:
                y2, x = F.fused_rms_norm_add(attn_out, x, post.weight,
                                             post.eps, plain=plain)
                x = x + self._mlp(i, layer.mlp, y2, plain)
        return y if fused else x

    def _logits(self, h, plain):
        if self.fused_block:
            return self._head_normed(h)
        return self.model._head(h, plain)

    # -- decode --------------------------------------------------------------

    def _fused_layer_active(self) -> bool:
        """Decode through the decode-layer kernel: asked for, taken by the
        model, and the user's switch ``PADDLE_TPU_FUSED_DECODE=0`` (the JAX
        engine's, ``paddle_tpu/serving/model.py:233-246``) not pulled."""
        return self.fused_decode_layer and \
            os.environ.get("PADDLE_TPU_FUSED_DECODE", "1") != "0"

    def decode_layer_refusal(self, batch: int, max_pages: int):
        """Why the decode-layer kernel would not take this model's decode
        step at ``batch`` rows and ``max_pages`` table entries, or None."""
        pool, m = self.pool, self.model
        dtypes = {p.dtype for p in m.parameters()} | {pool.k.dtype}
        if len(dtypes) != 1:
            return f"mixed dtypes {sorted(map(str, dtypes))}"
        return decode_layer.unsupported_reason(
            (batch, self.n_head, self.head_dim), tuple(pool.k.shape[1:]),
            max_pages, m.cfg.hidden_size, m.cfg.intermediate_size,
            pool.k.dtype)

    @torch.inference_mode()
    def decode_forward(self, tokens, positions, tables, plain=False):
        """One continuous-batch decode token per row.

        tokens ``[B]`` (last emitted token per slot), positions ``[B]``
        int32 (the position that token occupies: its KV is written there),
        tables ``[B, max_pages]`` int32, all on the model's device.
        Inactive slots carry position 0 and an all-trash table. Returns
        logits ``[B, vocab]`` for the next position.
        """
        pool = self.pool
        ps = pool.page_size
        pos = positions.to(torch.int32)
        tab = tables.to(torch.int32)
        b = tokens.shape[0]
        # int64 once per step: the per-layer KV writes index with them as
        # they are, launching no conversion of their own
        page_ids = tab.gather(1, (pos // ps).long()[:, None])[:, 0].long()
        slots = (pos % ps).long()
        cos_t, sin_t = self.model.rope(self.max_pos)
        cos, sin = cos_t[pos.long()], sin_t[pos.long()]     # [B, D] per token

        def write_kv(i, k, v):
            kv_cache.write_token(pool.k, i, page_ids, slots, k[:, 0])
            kv_cache.write_token(pool.v, i, page_ids, slots, v[:, 0])

        def attend(i, q, k, v):
            return kv_cache.paged_attention(q, pool, i, tab, pos, plain=plain)

        if self._fused_layer_active():
            return self._decode_forward_fused_layer(tokens, pos, tab, cos,
                                                    sin, write_kv, plain)
        x = self.model.embed_tokens(tokens.reshape(b, 1).long())
        h = self._layers(x, cos, sin, write_kv, attend, plain)
        return self._logits(h, plain)[:, 0]

    def _decode_forward_fused_layer(self, tokens, pos, tab, cos, sin,
                                    write_kv, plain):
        """A decode step through the decode-layer kernel
        (``paddle_tpu/serving/model.py:357-398``): per layer, QKV, RoPE and
        the two KV writes (a scatter into the pool cannot ride a kernel that
        reads through the page table), then one ``decode_layer`` call from
        the attention to the next layer's normed input and the residual
        stream. Layer 0's input norm is an RMSNorm, the final norm folds
        into the last layer's second junction, and the lm head reads the
        normed state: the fused epilogue path's dataflow."""
        pool = self.pool
        layers = list(self.model.layers)
        b = tokens.shape[0]
        fn = decode_layer.decode_layer_plain if plain else \
            decode_layer.decode_layer
        x = self.model.embed_tokens(tokens.reshape(b, 1).long())
        hres = x[:, 0]
        y = layers[0].input_layernorm(x, plain)
        for i, layer in enumerate(layers):
            q, k, v = self._qkv(i, layer, y, plain)
            q, k = F.rope(q, k, sin, cos, plain=plain)
            write_kv(i, k, v)
            post = layer.post_attention_layernorm
            nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) \
                else self.model.norm
            wo, wg, wu, wd = self._layer_mats(i, layer)
            y, hres = fn(q[:, 0], pool.k[i], pool.v[i], tab, pos, hres, wo,
                         post.weight, wg, wu, wd, nxt.weight,
                         eps_post=post.eps, eps_next=nxt.eps)
            y = y[:, None]
        return self._head_normed(y)[:, 0]

    # -- speculative verify --------------------------------------------------

    @torch.inference_mode()
    def verify_forward(self, tokens, positions, draft_len, tables,
                       plain=False):
        """One speculative verify step: the K + 1 lanes of every batch row
        (the last accepted token, then up to K drafts) in one forward over
        the paged pool (``paddle_tpu/serving/model.py:402``).

        tokens ``[B, S]`` (``S = K + 1``; lanes past ``1 + draft_len`` are
        padding), positions ``[B]`` int32 (lane 0's position, the row's
        ``cur_len - 1``), draft_len ``[B]`` int32, tables ``[B,
        max_pages]`` int32, all on the model's device. Each valid lane
        writes its KV through the row's table (the scheduler has grown the
        table and copied any shared page in the span); a padding lane
        writes to the trash page. Returns logits ``[B, S, vocab]`` (lane
        ``i``: the distribution at position ``base + i + 1``).

        The attention is the mmha kernel over the ``B * S`` lanes as rows:
        lane ``i`` of row ``b`` reads ``b``'s table up to position
        ``base + i``, the JAX rule ``j <= base + i``. (The JAX verify
        gathers every row's whole table and runs the f32
        ``chunk_attention`` composite; the function is the same.) The
        plain version runs ``mmha_plain`` on the same lanes."""
        pool = self.pool
        ps = pool.page_size
        b, s = tokens.shape
        base = positions.to(torch.int32)
        dlen = draft_len.to(torch.int32)
        tab = tables.to(torch.int32)
        max_pages = tab.shape[1]
        lane = torch.arange(s, device=tokens.device, dtype=torch.int32)[None]
        pos = base[:, None] + lane                                # [B, S]
        valid = lane <= dlen[:, None]
        pos_c = pos.clamp(0, self.max_pos - 1)
        page_idx = (pos_c // ps).clamp(max=max_pages - 1).long()
        w_page = torch.where(valid, tab.gather(1, page_idx),
                             torch.full_like(pos, kv_cache.TRASH_PAGE))
        w_page = w_page.reshape(-1).long()
        w_slot = (pos_c % ps).reshape(-1).long()
        flat = pos_c.reshape(-1).long()
        cos_t, sin_t = self.model.rope(self.max_pos)
        cos, sin = cos_t[flat], sin_t[flat]                       # [B*S, D]
        # the lanes as rows of one decode attention: each row's table once
        # a lane, int32 and contiguous, built once a step
        tab_lanes = tab.repeat_interleave(s, dim=0)
        pos_lanes = pos.clamp(0, max_pages * ps - 1).reshape(-1)

        def write_kv(i, k, v):
            kv_cache.write_token(pool.k, i, w_page, w_slot,
                                 k.reshape(b * s, self.n_kv, self.head_dim))
            kv_cache.write_token(pool.v, i, w_page, w_slot,
                                 v.reshape(b * s, self.n_kv, self.head_dim))

        def attend(i, q, k, v):
            q1 = q.reshape(b * s, 1, self.n_head, self.head_dim).contiguous()
            out = kv_cache.paged_attention(q1, pool, i, tab_lanes,
                                           pos_lanes, plain=plain)
            return out.reshape(b, s, self.n_head, self.head_dim)

        x = self.model.embed_tokens(tokens.long())
        h = self._layers(x, cos, sin, write_kv, attend, plain)
        return self._logits(h, plain)

    # -- monolithic prefill --------------------------------------------------

    @torch.inference_mode()
    def prefill_forward(self, tokens, prompt_len: int, table_row,
                        plain=False):
        """Whole-prompt forward for one request, writing its KV pages.

        tokens ``[1, n]`` with ``n >= prompt_len``; the engine passes the
        prompt at its own length (the JAX engine pads it to a power-of-two
        bucket, so that one compiled program serves the bucket: the port
        compiles nothing, and the outputs at real positions are the same
        either way). Positions past ``prompt_len`` write to the trash page
        and causal attention keeps them out of every real position.
        table_row ``[max_pages]`` int32. Attention is the flash kernel over
        the prompt's own q, k, v. Returns logits ``[1, vocab]`` at position
        ``prompt_len - 1`` (the first generated token's distribution).
        """
        pool = self.pool
        n = tokens.shape[1]
        tab_row = table_row.to(torch.int32)
        cos_t, sin_t = self.model.rope(self.max_pos)
        cos, sin = cos_t[:n], sin_t[:n]                      # [n, D]

        def write_kv(i, k, v):
            kv_cache.write_prefill(pool.k, i, tab_row, prompt_len, k[0],
                                   pool.page_size)
            kv_cache.write_prefill(pool.v, i, tab_row, prompt_len, v[0],
                                   pool.page_size)

        def attend(i, q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  plain=plain)

        x = self.model.embed_tokens(tokens.long())
        h = self._layers(x, cos, sin, write_kv, attend, plain)
        last = h[:, prompt_len - 1:prompt_len]
        return self._logits(last, plain)[:, 0]

    # -- chunked prefill -----------------------------------------------------

    @torch.inference_mode()
    def prefill_chunk_forward(self, tokens, start: int, chunk_len: int,
                              table_row, plain=False):
        """One prefill chunk: positions ``[start, start + chunk_len)`` of a
        request, attending to everything already resident through its
        page table (earlier chunks and claimed prefix pages).

        tokens ``[1, C]`` with ``C >= chunk_len`` (lanes past ``chunk_len``
        are padding: their KV goes to the trash page and nothing reads
        their outputs); table_row ``[max_pages]`` int32. Returns logits
        ``[1, vocab]`` at the chunk's last valid position (the first
        generated token's distribution on the final chunk).
        """
        pool = self.pool
        ps = pool.page_size
        n = tokens.shape[1]
        dev = tokens.device
        tab_row = table_row.to(torch.int32)
        t_loc = torch.arange(n, device=dev)
        pos = start + t_loc
        pos_c = pos.clamp(0, self.max_pos - 1)
        cos_t, sin_t = self.model.rope(self.max_pos)
        cos, sin = cos_t[pos_c], sin_t[pos_c]                # [C, D]
        page_idx = (pos // ps).clamp(max=tab_row.shape[0] - 1)
        w_page = torch.where(t_loc < chunk_len, tab_row.long()[page_idx],
                             torch.full_like(page_idx, kv_cache.TRASH_PAGE))
        w_slot = pos % ps

        def write_kv(i, k, v):
            kv_cache.write_token(pool.k, i, w_page, w_slot, k[0])
            kv_cache.write_token(pool.v, i, w_page, w_slot, v[0])

        def attend(i, q, k, v):
            kc = kv_cache.gather_layer(pool.k, i, tab_row[None])
            vc = kv_cache.gather_layer(pool.v, i, tab_row[None])
            return kv_cache.chunk_attention(q, kc, vc, start)

        x = self.model.embed_tokens(tokens.long())
        h = self._layers(x, cos, sin, write_kv, attend, plain)
        last = h[:, chunk_len - 1:chunk_len]
        return self._logits(last, plain)[:, 0]

"""GPT: causal decoder-only transformer for generative serving.

Counterpart of ``paddle_tpu/models/gpt.py``: the same builders, the same
explicit ``gpt_*`` parameter names and the same state-var table, so a
program built here has the JAX package's ops, vars and attrs, and
parameters carry across by name (``interop.scope_from_numpy``).

* **prefill** — full-sequence causal forward over a padded prompt bucket:
  writes every layer's K/V into the paged caches, samples the first
  generated token and merges the per-slot generation state under a slot
  mask.
* **decode** — one token for every slot at per-slot positions, with no
  feeds: token, position and caches are persistable state, updated in
  place by the executor, so ``run_chained`` runs a decode chunk with no
  host round-trip per token.
* **chunk** — a q_len = C slice of a chunked prefill (or the
  speculative-decoding verify step) over the paged cache.

Only the prefill builder's startup program initializes the parameters;
the generation state is planted by the serving layer.
"""
from __future__ import annotations

import dataclasses
import math

from .. import layers
from ..framework import Program, program_guard
from ..initializer import TruncatedNormal
from ..param_attr import ParamAttr

__all__ = ["GptConfig", "build_gpt_prefill", "build_gpt_decode",
           "build_gpt_chunk", "build_gpt_generative"]


@dataclasses.dataclass
class GptConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    initializer_range: float = 0.02

    @staticmethod
    def base():
        return GptConfig()

    @staticmethod
    def tiny():
        """CI-sized config (the load_check --decode probe)."""
        return GptConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, intermediate_size=128,
                         max_position=128)


def _attr(name: str, rng: float):
    return ParamAttr(name=name, initializer=TruncatedNormal(0.0, rng))


def _embed(ids, cfg: GptConfig):
    """Token + (separately applied) position embeddings share one builder
    so prefill and decode stay bit-identical."""
    return layers.embedding(ids, (cfg.vocab_size, cfg.hidden_size),
                            param_attr=_attr("gpt_word_emb",
                                             cfg.initializer_range))


def _pos_embed(pos_ids, cfg: GptConfig):
    return layers.embedding(pos_ids, (cfg.max_position, cfg.hidden_size),
                            param_attr=_attr("gpt_pos_emb",
                                             cfg.initializer_range))


def _ln(x, prefix: str, axis: int = 2):
    return layers.layer_norm(x, begin_norm_axis=axis,
                             param_attr=ParamAttr(name=f"{prefix}_scale"),
                             bias_attr=ParamAttr(name=f"{prefix}_bias"))


def _proj(x, size, name, cfg: GptConfig, act=None):
    return layers.fc(x, size, num_flatten_dims=2, act=act,
                     param_attr=_attr(f"{name}_w", cfg.initializer_range),
                     bias_attr=ParamAttr(name=f"{name}_b"))


def _split_heads(t, seq_len, cfg: GptConfig):
    """[B, S, H] -> [B, nh, S, hd]."""
    t = layers.reshape(t, [0, seq_len, cfg.num_heads,
                           cfg.hidden_size // cfg.num_heads])
    return layers.transpose(t, [0, 2, 1, 3])


def _merge_heads(t, seq_len, cfg: GptConfig):
    """[B, nh, S, hd] -> [B, S, H]."""
    t = layers.transpose(t, [0, 2, 1, 3])
    return layers.reshape(t, [0, seq_len, cfg.hidden_size])


def _mlp(x, prefix: str, cfg: GptConfig):
    h = _proj(x, cfg.intermediate_size, f"{prefix}_ffn1", cfg, act="gelu")
    return _proj(h, cfg.hidden_size, f"{prefix}_ffn2", cfg)


def _logits(h2d, cfg: GptConfig, block):
    """[B|BS, H] hidden rows -> vocab logits via the tied word embedding."""
    word_emb = block.var("gpt_word_emb")
    return layers.matmul(h2d, word_emb, transpose_y=True)


def _state_vars(block, cfg: GptConfig, batch_slots: int, max_seq: int):
    """Declare (or re-declare, in the sibling program) the generation
    state: current token, current position, the per-slot ACTIVE mask, and
    one paged K/V cache pair per layer. Persistable — the executor
    threads them step to step and the cache ops update them in place.

    ``gpt_gen_active`` [B, 1] float32 is 1 while a slot is mid-stream
    (set in-program when a prefill/chunk commits a slot's first token,
    zeroed host-side on retire/reset): the decode program gates its cache
    appends and state merges on it, so retired slots and slots still
    inside a chunked prefill neither advance nor write K/V rows while
    their neighbours decode."""
    hd = cfg.hidden_size // cfg.num_heads
    sv = {}

    def mk(name, shape, dtype):
        block.create_var(name=name, shape=tuple(shape), dtype=dtype,
                         persistable=True, stop_gradient=True)
        sv[name] = (tuple(shape), dtype)
        return block.var(name)

    tok = mk("gpt_gen_tokens", (batch_slots, 1), "int64")
    pos = mk("gpt_gen_pos", (batch_slots, 1), "int64")
    active = mk("gpt_gen_active", (batch_slots, 1), "float32")
    caches = []
    for i in range(cfg.num_layers):
        ck = mk(f"gpt_kv_k_{i}", (batch_slots, cfg.num_heads, max_seq, hd),
                "float32")
        cv = mk(f"gpt_kv_v_{i}", (batch_slots, cfg.num_heads, max_seq, hd),
                "float32")
        caches.append((ck, cv))
    return tok, pos, active, caches, sv


def _merge_state(new, old, mask_i64, inv_mask_i64):
    """masked select: new where the slot mask is set, old elsewhere; the
    reads of ``old`` precede the caller's write-back."""
    return layers.elementwise_add(layers.elementwise_mul(new, mask_i64),
                                  layers.elementwise_mul(old, inv_mask_i64))


def _activate_slots(active, mask_f32, one_f32):
    """active := 1 where ``mask_f32`` is set, unchanged elsewhere (the
    float face of :func:`_merge_state`): a prefill/chunk that commits a
    slot's first token flips that slot's decode gate in-program."""
    inv = layers.elementwise_sub(one_f32, mask_f32)
    layers.assign(layers.elementwise_add(
        mask_f32, layers.elementwise_mul(active, inv)), output=active)


def build_gpt_prefill(cfg: GptConfig, batch_slots: int, prompt_bucket: int,
                      max_seq: int, page_size: int = 8,
                      strategy: str = "greedy", temperature: float = 1.0,
                      top_k: int = 0, fetch_logits: bool = False,
                      startup: Program = None):
    """The full-sequence phase for ONE prompt bucket (prompts padded to
    ``prompt_bucket`` tokens). Feeds (all with the static ``batch_slots``
    leading dim — every dispatch carries the full slot batch):

    * ``prompt_ids``  [B, S] int64 — padded prompt tokens;
    * ``prompt_pos``  [B, S] int64 — position ids (0..S-1);
    * ``prompt_mask`` [B, S] float32 — 1 on real tokens, 0 on pads;
    * ``prompt_len``  [B, 1] int64 — real prompt length per slot;
    * ``slot_mask``   [B, 1] float32 — 1 on slots being (re)filled; other
      slots' caches and generation state pass through untouched.

    Pass ``startup`` to share one startup program across buckets (only
    the first call's parameter initializers land there)."""
    if prompt_bucket > max_seq:
        raise ValueError(f"prompt_bucket {prompt_bucket} exceeds the KV "
                         f"capacity max_seq {max_seq}")
    if max_seq % page_size:
        raise ValueError(f"max_seq {max_seq} must be a whole number of "
                         f"pages of page_size {page_size}")
    B, S = batch_slots, prompt_bucket
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    main = Program()
    own_startup = startup is None
    startup = startup if startup is not None else Program()
    throwaway = Program()
    with program_guard(main, startup if own_startup else throwaway):
        ids = layers.data("prompt_ids", shape=[B, S], dtype="int64",
                          append_batch_size=False)
        pos_ids = layers.data("prompt_pos", shape=[B, S], dtype="int64",
                              append_batch_size=False)
        pmask = layers.data("prompt_mask", shape=[B, S], dtype="float32",
                            append_batch_size=False)
        plen = layers.data("prompt_len", shape=[B, 1], dtype="int64",
                           append_batch_size=False)
        smask = layers.data("slot_mask", shape=[B, 1], dtype="float32",
                            append_batch_size=False)
        tok, pos, active, caches, sv = _state_vars(main.global_block, cfg,
                                                   B, max_seq)

        x = layers.elementwise_add(_embed(ids, cfg), _pos_embed(pos_ids, cfg))
        # additive key-padding bias [B,1,1,S]: (mask-1)*10000, bert idiom
        bias = layers.unsqueeze(
            layers.scale(pmask, scale=10000.0, bias=-10000.0), [1, 2])
        zero_pos = layers.fill_constant([B, 1], "int64", 0)
        for i in range(cfg.num_layers):
            p = f"gpt_l{i}"
            h = _ln(x, f"{p}_ln1")
            q = _split_heads(_proj(h, cfg.hidden_size, f"{p}_q", cfg), S, cfg)
            k = _split_heads(_proj(h, cfg.hidden_size, f"{p}_k", cfg), S, cfg)
            v = _split_heads(_proj(h, cfg.hidden_size, f"{p}_v", cfg), S, cfg)
            ck, cv = caches[i]
            # bulk KV write: whole prompt at position 0, slot-masked so
            # neighbouring sequences' pages survive a refill
            layers.kv_cache_append(ck, k, zero_pos, slot_mask=smask)
            layers.kv_cache_append(cv, v, zero_pos, slot_mask=smask)
            ctx = layers.fused_multihead_attention(
                q, k, v, bias_qk=bias, causal=True,
                scale=1.0 / math.sqrt(hd), is_test=True)
            att = _proj(_merge_heads(ctx, S, cfg), cfg.hidden_size,
                        f"{p}_out", cfg)
            x = layers.elementwise_add(x, att)
            h = _ln(x, f"{p}_ln2")
            x = layers.elementwise_add(x, _mlp(h, p, cfg))
        h = _ln(x, "gpt_lnf")

        one = layers.fill_constant([B, 1], "int64", 1)
        last = layers.elementwise_sub(plen, one)
        last_h = layers.sequence_gather(h, last)            # [B, H]
        logits = _logits(last_h, cfg, main.global_block)    # [B, V]
        first_tok = layers.sample_token(logits, strategy=strategy,
                                        temperature=temperature, top_k=top_k)

        mask_i64 = layers.cast(smask, "int64")
        inv = layers.elementwise_sub(one, mask_i64)
        layers.assign(_merge_state(first_tok, tok, mask_i64, inv),
                      output=tok)
        layers.assign(_merge_state(plen, pos, mask_i64, inv), output=pos)
        one_f = layers.fill_constant([B, 1], "float32", 1.0)
        _activate_slots(active, smask, one_f)

        out = {"main": main, "startup": startup,
               "first_token": first_tok, "state_vars": sv,
               "feeds": ("prompt_ids", "prompt_pos", "prompt_mask",
                         "prompt_len", "slot_mask")}
        if fetch_logits:
            # all-position logits for the continuity tests
            flat = layers.reshape(h, [0, S * cfg.hidden_size])
            flat = layers.reshape(flat, [B * S, cfg.hidden_size])
            all_logits = layers.reshape(
                _logits(flat, cfg, main.global_block),
                [B, S, cfg.vocab_size])
            out["logits"] = all_logits
            out["last_logits"] = logits
    return out


def build_gpt_decode(cfg: GptConfig, batch_slots: int, max_seq: int,
                     page_size: int = 8, strategy: str = "greedy",
                     temperature: float = 1.0, top_k: int = 0,
                     fetch_logits: bool = False):
    """The per-token phase: no feeds — everything (current token, position,
    paged KV caches) is persistable state, so ``run_chained`` runs whole
    decode chunks with the caches updated in place. Fetch
    ``next_token`` ([B, 1] int64; stacked [steps, B, 1] under
    ``run_chained``). Sequences at different positions batch together: the
    position is data, not shape, so every chunk reuses one program."""
    if max_seq % page_size:
        raise ValueError(f"max_seq {max_seq} must be a whole number of "
                         f"pages of page_size {page_size}")
    B = batch_slots
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    main, throwaway = Program(), Program()
    with program_guard(main, throwaway):
        tok, pos, active, caches, sv = _state_vars(main.global_block, cfg,
                                                   B, max_seq)
        pos_cap = layers.fill_constant([B, 1], "int64",
                                       cfg.max_position - 1)
        pos_emb_ids = layers.elementwise_min(pos, pos_cap)
        # lookup_table squeezes the trailing ids dim ([B,1] -> [B,H]);
        # restore the length-1 sequence axis the layer stack expects
        x = layers.unsqueeze(
            layers.elementwise_add(_embed(tok, cfg),
                                   _pos_embed(pos_emb_ids, cfg)), [1])
        for i in range(cfg.num_layers):
            p = f"gpt_l{i}"
            h = _ln(x, f"{p}_ln1")
            q = _split_heads(_proj(h, cfg.hidden_size, f"{p}_q", cfg), 1, cfg)
            k = _split_heads(_proj(h, cfg.hidden_size, f"{p}_k", cfg), 1, cfg)
            v = _split_heads(_proj(h, cfg.hidden_size, f"{p}_v", cfg), 1, cfg)
            ck, cv = caches[i]
            # append + attend in ONE op: the caches' only read+write site;
            # the active gate keeps retired / mid-chunk-prefill slots'
            # caches bit-untouched while their neighbours decode
            ctx = layers.fused_decode_attention(
                q, k, v, ck, cv, pos, scale=1.0 / math.sqrt(hd),
                page_size=page_size, slot_mask=active)
            att = _proj(_merge_heads(ctx, 1, cfg), cfg.hidden_size,
                        f"{p}_out", cfg)
            x = layers.elementwise_add(x, att)
            h = _ln(x, f"{p}_ln2")
            x = layers.elementwise_add(x, _mlp(h, p, cfg))
        h = _ln(x, "gpt_lnf")
        last_h = layers.reshape(h, [0, cfg.hidden_size])     # [B, H]
        logits = _logits(last_h, cfg, main.global_block)     # [B, V]
        next_tok = layers.sample_token(logits, strategy=strategy,
                                       temperature=temperature, top_k=top_k)
        one = layers.fill_constant([B, 1], "int64", 1)
        seq_cap = layers.fill_constant([B, 1], "int64", max_seq)
        # inactive slots neither advance their token nor their position
        # (position would otherwise saturate at max_seq overwriting the
        # last cache row; with the gate it simply freezes)
        act_i64 = layers.cast(active, "int64")
        inv = layers.elementwise_sub(one, act_i64)
        layers.assign(_merge_state(next_tok, tok, act_i64, inv), output=tok)
        new_pos = layers.elementwise_min(
            layers.elementwise_add(pos, one), seq_cap)
        layers.assign(_merge_state(new_pos, pos, act_i64, inv), output=pos)
        out = {"main": main, "next_token": next_tok, "state_vars": sv}
        if fetch_logits:
            out["logits"] = logits
    return out


def build_gpt_chunk(cfg: GptConfig, batch_slots: int, chunk: int,
                    max_seq: int, page_size: int = 8,
                    strategy: str = "greedy", temperature: float = 1.0,
                    top_k: int = 0, mode: str = "prefill"):
    """The q_len=C chunk phase over the paged cache — one program serves
    two schedulers:

    * ``mode='prefill'`` — one C-token slice of a chunked prefill: a long
      cold prompt (or the un-cached suffix after a prefix-cache hit) is
      admitted slice by slice between decode chunks, so resident decoders
      never stall behind a monolithic prefill. Feeds:

      - ``chunk_ids``   [B, C] int64 — this slice's tokens (padded);
      - ``chunk_pos``   [B, C] int64 — absolute position ids (host-fed,
        clamped to the position table);
      - ``chunk_start`` [B, 1] int64 — cache rows already written (the
        slice's append position);
      - ``chunk_len``   [B, 1] int64 — real tokens in this slice (1..C);
      - ``slot_mask``   [B, 1] float32 — slots in this dispatch;
      - ``sample_mask`` [B, 1] float32 — 1 on a prompt's FINAL slice:
        sample the first generated token from position ``chunk_len - 1``,
        commit it to the token state and flip the slot's decode gate.

      Position state advances by ``chunk_len`` on every slice (slot-
      masked); padding rows past ``chunk_len`` write K/V at positions the
      next slice overwrites, and the per-row causal mask keeps them out
      of every real query's softmax.

    * ``mode='verify'`` — the speculative-decoding verify step
      (C = 1 + draft length): ``chunk_ids`` carries the last committed
      token followed by the draft's proposals, the target scores every
      position in ONE dispatch, and ``layers.spec_accept`` commits the
      longest agreeing prefix + bonus token wholly in-program. Extra
      feed ``draft_ids`` [B, C-1] int64; no ``chunk_len``/``sample_mask``
      (a verify chunk is always full). Fetches ``sampled`` [B, C] (the
      target's token at every chunk position — the host streams
      ``sampled[:m+1]``) and ``accept_len`` [B, 1].
    """
    if mode not in ("prefill", "verify"):
        raise ValueError(f"build_gpt_chunk: mode must be 'prefill' or "
                         f"'verify', got {mode!r}")
    if chunk < 1:
        raise ValueError(f"build_gpt_chunk: chunk must be >= 1, got {chunk}")
    if mode == "verify" and chunk < 2:
        raise ValueError("build_gpt_chunk: a verify chunk needs >= 2 "
                         "positions (one committed token + >= 1 draft)")
    if max_seq % page_size:
        raise ValueError(f"max_seq {max_seq} must be a whole number of "
                         f"pages of page_size {page_size}")
    B, C = batch_slots, chunk
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    main, throwaway = Program(), Program()
    with program_guard(main, throwaway):
        ids = layers.data("chunk_ids", shape=[B, C], dtype="int64",
                          append_batch_size=False)
        pos_ids = layers.data("chunk_pos", shape=[B, C], dtype="int64",
                              append_batch_size=False)
        start = layers.data("chunk_start", shape=[B, 1], dtype="int64",
                            append_batch_size=False)
        smask = layers.data("slot_mask", shape=[B, 1], dtype="float32",
                            append_batch_size=False)
        if mode == "prefill":
            clen = layers.data("chunk_len", shape=[B, 1], dtype="int64",
                               append_batch_size=False)
            sample_mask = layers.data("sample_mask", shape=[B, 1],
                                      dtype="float32",
                                      append_batch_size=False)
            feeds = ("chunk_ids", "chunk_pos", "chunk_start", "chunk_len",
                     "slot_mask", "sample_mask")
        else:
            drafts = layers.data("draft_ids", shape=[B, C - 1],
                                 dtype="int64", append_batch_size=False)
            feeds = ("chunk_ids", "chunk_pos", "chunk_start", "slot_mask",
                     "draft_ids")
        tok, pos, active, caches, sv = _state_vars(main.global_block, cfg,
                                                   B, max_seq)

        x = layers.elementwise_add(_embed(ids, cfg), _pos_embed(pos_ids, cfg))
        for i in range(cfg.num_layers):
            p = f"gpt_l{i}"
            h = _ln(x, f"{p}_ln1")
            q = _split_heads(_proj(h, cfg.hidden_size, f"{p}_q", cfg), C, cfg)
            k = _split_heads(_proj(h, cfg.hidden_size, f"{p}_k", cfg), C, cfg)
            v = _split_heads(_proj(h, cfg.hidden_size, f"{p}_v", cfg), C, cfg)
            ck, cv = caches[i]
            # C-row append + chunk-causal attend in ONE op, like
            # decode; the slot mask keeps every other
            # slot's pages bit-untouched
            ctx = layers.fused_decode_attention(
                q, k, v, ck, cv, start, scale=1.0 / math.sqrt(hd),
                page_size=page_size, slot_mask=smask)
            att = _proj(_merge_heads(ctx, C, cfg), cfg.hidden_size,
                        f"{p}_out", cfg)
            x = layers.elementwise_add(x, att)
            h = _ln(x, f"{p}_ln2")
            x = layers.elementwise_add(x, _mlp(h, p, cfg))
        h = _ln(x, "gpt_lnf")

        one = layers.fill_constant([B, 1], "int64", 1)
        out = {"main": main, "state_vars": sv, "feeds": feeds,
               "chunk": C, "mode": mode}
        if mode == "prefill":
            last = layers.elementwise_sub(clen, one)
            last_h = layers.sequence_gather(h, last)          # [B, H]
            logits = _logits(last_h, cfg, main.global_block)  # [B, V]
            first_tok = layers.sample_token(logits, strategy=strategy,
                                            temperature=temperature,
                                            top_k=top_k)
            # position advances by the slice length on EVERY slice; the
            # token + decode gate commit only on the final slice
            smask_i64 = layers.cast(smask, "int64")
            inv_s = layers.elementwise_sub(one, smask_i64)
            new_pos = layers.elementwise_add(start, clen)
            layers.assign(_merge_state(new_pos, pos, smask_i64, inv_s),
                          output=pos)
            eff = layers.elementwise_mul(smask, sample_mask)
            eff_i64 = layers.cast(eff, "int64")
            inv_e = layers.elementwise_sub(one, eff_i64)
            layers.assign(_merge_state(first_tok, tok, eff_i64, inv_e),
                          output=tok)
            one_f = layers.fill_constant([B, 1], "float32", 1.0)
            _activate_slots(active, eff, one_f)
            out["first_token"] = first_tok
        else:
            flat = layers.reshape(h, [0, C * cfg.hidden_size])
            flat = layers.reshape(flat, [B * C, cfg.hidden_size])
            logits = _logits(flat, cfg, main.global_block)    # [B*C, V]
            sampled = layers.sample_token(logits, strategy=strategy,
                                          temperature=temperature,
                                          top_k=top_k)         # [B*C, 1]
            sampled_bc = layers.reshape(sampled, [B, C])
            accept, new_tok, new_pos = layers.spec_accept(
                sampled_bc, drafts, start)
            smask_i64 = layers.cast(smask, "int64")
            inv_s = layers.elementwise_sub(one, smask_i64)
            layers.assign(_merge_state(new_tok, tok, smask_i64, inv_s),
                          output=tok)
            layers.assign(_merge_state(new_pos, pos, smask_i64, inv_s),
                          output=pos)
            out["sampled"] = sampled_bc
            out["accept_len"] = accept
            out["next_token"] = new_tok
    return out


def build_gpt_generative(cfg: GptConfig = None, batch_slots: int = 4,
                         max_seq: int = 64, page_size: int = 8,
                         prompt_buckets=(16,), strategy: str = "greedy",
                         temperature: float = 1.0, top_k: int = 0,
                         fetch_logits: bool = False,
                         prefill_chunk: int = None, spec_k: int = 4):
    """Everything the generative serving engine needs: one prefill program
    per prompt bucket + one decode program + the chunked-prefill and
    speculative-verify chunk programs over shared weights, one
    startup program (parameters only — generation state is reset
    host-side by the engine), and the state-var table.

    ``prefill_chunk`` (default: one page) sizes the chunked-prefill
    slice; ``spec_k`` sizes the speculative chunk (1 committed token +
    ``spec_k - 1`` drafts per verify dispatch; ``spec_k < 2`` skips
    building the verify program)."""
    cfg = cfg or GptConfig.tiny()
    if cfg.max_position < max_seq:
        raise ValueError(f"max_seq {max_seq} exceeds the position table "
                         f"max_position {cfg.max_position}")
    prompt_buckets = tuple(sorted(set(int(b) for b in prompt_buckets)))
    if not prompt_buckets:
        raise ValueError("need at least one prompt bucket")
    prefill_chunk = int(prefill_chunk or page_size)
    prefill = {}
    startup = None
    for S in prompt_buckets:
        net = build_gpt_prefill(cfg, batch_slots, S, max_seq,
                                page_size=page_size, strategy=strategy,
                                temperature=temperature, top_k=top_k,
                                fetch_logits=fetch_logits, startup=startup)
        startup = net["startup"]
        prefill[S] = net
    decode = build_gpt_decode(cfg, batch_slots, max_seq,
                              page_size=page_size, strategy=strategy,
                              temperature=temperature, top_k=top_k,
                              fetch_logits=fetch_logits)
    chunk = build_gpt_chunk(cfg, batch_slots, prefill_chunk, max_seq,
                            page_size=page_size, strategy=strategy,
                            temperature=temperature, top_k=top_k,
                            mode="prefill")
    verify = None
    if spec_k >= 2:
        verify = build_gpt_chunk(cfg, batch_slots, spec_k, max_seq,
                                 page_size=page_size, strategy=strategy,
                                 temperature=temperature, top_k=top_k,
                                 mode="verify")
    return {"config": cfg, "startup": startup, "prefill": prefill,
            "decode": decode, "chunk": chunk, "verify": verify,
            "state_vars": decode["state_vars"],
            "batch_slots": batch_slots, "max_seq": max_seq,
            "page_size": page_size, "prompt_buckets": prompt_buckets,
            "prefill_chunk": prefill_chunk, "spec_k": int(spec_k),
            "strategy": strategy}

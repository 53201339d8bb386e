"""Seq2seq (encoder-decoder RNN) with beam-search decoding (counterpart
of ``paddle_tpu/models/seq2seq.py``, the same programs and parameter
names).

Reference: the machine_translation book test
(python/paddle/fluid/tests/book/test_machine_translation.py) — encoder RNN,
teacher-forced decoder RNN for training, While-loop beam-search decoder for
inference (layers/control_flow.py While + beam_search ops).

The encoder and decoder are StaticRNNs (one ``recurrent`` op each); the
decode loop is a bounded While (``max_len``) over dense [batch*beam] state.
``build_seq2seq_train_varlen`` trains on lod_level-1 feeds (the padded +
``@LOD`` lengths encoding), masked by the lengths.
"""
from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..framework import Program, program_guard
from ..param_attr import ParamAttr

__all__ = ["build_seq2seq_train", "build_seq2seq_train_varlen",
           "build_seq2seq_infer"]


def _cell(x_t, h_prev, hidden, name):
    """tanh RNN cell with shared (named) parameters."""
    merged = layers.concat([x_t, h_prev], axis=1)
    return layers.tanh(layers.fc(
        merged, hidden, bias_attr=False,
        param_attr=ParamAttr(name=f"{name}_w"), name=name))


def build_seq2seq_train(src_vocab, tgt_vocab, emb_dim=32, hidden=64,
                        src_len=8, tgt_len=8, batch=16, lr=1e-3):
    """Training program: returns dict with programs, feeds, loss."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[batch, src_len], dtype="int64",
                          append_batch_size=False)
        tgt_in = layers.data("tgt_in_ids", shape=[batch, tgt_len],
                             dtype="int64", append_batch_size=False)
        tgt_out = layers.data("tgt_out_ids", shape=[batch, tgt_len],
                              dtype="int64", append_batch_size=False)

        src_emb = layers.embedding(
            src, size=[src_vocab, emb_dim],
            param_attr=ParamAttr(name="src_emb_w"))      # [B, S, E]
        src_tm = layers.transpose(src_emb, [1, 0, 2])    # time-major

        enc = layers.StaticRNN()
        with enc.step():
            x_t = enc.step_input(src_tm)
            h_p = enc.memory(shape=[hidden], batch_ref=src_tm)
            h = _cell(x_t, h_p, hidden, "enc_cell")
            enc.update_memory(h_p, h)
            enc.step_output(h)
        enc_states = enc()                                # [S, B, H]
        enc_final = layers.reshape(
            layers.slice(enc_states, axes=[0], starts=[src_len - 1],
                         ends=[src_len]), [batch, hidden])

        tgt_emb = layers.embedding(
            tgt_in, size=[tgt_vocab, emb_dim],
            param_attr=ParamAttr(name="tgt_emb_w"))
        tgt_tm = layers.transpose(tgt_emb, [1, 0, 2])

        dec = layers.StaticRNN()
        with dec.step():
            x_t = dec.step_input(tgt_tm)
            h_p = dec.memory(init=enc_final)
            h = _cell(x_t, h_p, hidden, "dec_cell")
            dec.update_memory(h_p, h)
            dec.step_output(h)
        dec_states = dec()                                # [T, B, H]
        flat = layers.reshape(dec_states, [tgt_len * batch, hidden])
        logits = layers.fc(flat, tgt_vocab,
                           param_attr=ParamAttr(name="proj_w"),
                           bias_attr=False, name="proj")
        labels_tm = layers.transpose(tgt_out, [1, 0])     # [T, B]
        labels = layers.reshape(labels_tm, [tgt_len * batch, 1])
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, labels))
        optimizer.Adam(lr).minimize(loss)
    return {"main": main, "startup": startup, "loss": loss,
            "feeds": ["src_ids", "tgt_in_ids", "tgt_out_ids"]}


def build_seq2seq_train_varlen(src_vocab, tgt_vocab, emb_dim=32, hidden=64,
                               lr=1e-3):
    """Variable-length training path: src/tgt are lod_level-1 feeds in the
    padded + lengths encoding; the encoder's final state is the LAST valid
    step (sequence_pool), and the token loss is masked by the target
    lengths (sequence_pool SUM / total tokens) so pad positions contribute
    nothing. The loss does not depend on the padded length."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[1], dtype="int64", lod_level=1)
        tgt_in = layers.data("tgt_in_ids", shape=[1], dtype="int64",
                             lod_level=1)
        tgt_out = layers.data("tgt_out_ids", shape=[1], dtype="int64",
                              lod_level=1)

        src_emb = layers.embedding(
            src, size=[src_vocab, emb_dim],
            param_attr=ParamAttr(name="src_emb_w"))       # [B, S, E]
        src_tm = layers.transpose(src_emb, [1, 0, 2])     # time-major

        enc = layers.StaticRNN()
        with enc.step():
            x_t = enc.step_input(src_tm)
            h_p = enc.memory(shape=[hidden], batch_ref=src_tm)
            h = _cell(x_t, h_p, hidden, "enc_cell")
            enc.update_memory(h_p, h)
            enc.step_output(h)
        enc_bm = layers.transpose(enc(), [1, 0, 2])       # [B, S, H]
        # last VALID state per source sequence (not the padded final step);
        # lengths are inferred through the transpose/scan/embedding chain
        enc_final = layers.sequence_pool(enc_bm, "last")

        tgt_emb = layers.embedding(
            tgt_in, size=[tgt_vocab, emb_dim],
            param_attr=ParamAttr(name="tgt_emb_w"))
        tgt_tm = layers.transpose(tgt_emb, [1, 0, 2])

        dec = layers.StaticRNN()
        with dec.step():
            x_t = dec.step_input(tgt_tm)
            h_p = dec.memory(init=enc_final)
            h = _cell(x_t, h_p, hidden, "dec_cell")
            dec.update_memory(h_p, h)
            dec.step_output(h)
        dec_bm = layers.transpose(dec(), [1, 0, 2])       # [B, T, H]
        logits = layers.fc(dec_bm, tgt_vocab, num_flatten_dims=2,
                           param_attr=ParamAttr(name="proj_w"),
                           bias_attr=False, name="proj")  # [B, T, V]
        ce = layers.softmax_with_cross_entropy(logits, tgt_out)  # [B, T, 1]
        ce = layers.squeeze(ce, axes=[2])                 # [B, T]
        seq_loss = layers.sequence_pool(ce, "sum")        # masked per-seq sum
        n_tokens = layers.cast(layers.reduce_sum(
            layers.sequence.seq_len_var(tgt_out)), "float32")
        loss = layers.elementwise_div(layers.reduce_sum(seq_loss), n_tokens)
        optimizer.Adam(lr).minimize(loss)
    return {"main": main, "startup": startup, "loss": loss,
            "feeds": ["src_ids", "tgt_in_ids", "tgt_out_ids"],
            "feed_vars": [src, tgt_in, tgt_out]}


def build_seq2seq_infer(src_vocab, tgt_vocab, emb_dim=32, hidden=64,
                        src_len=8, batch=4, beam_size=4, max_len=8,
                        bos_id=0, eos_id=1):
    """Beam-search decode program sharing parameter names with training.

    Returns dict with program, feed name, fetches [ids, scores]:
    ``decoded_ids`` is [max_len + 1, batch*beam] chronological tokens (the
    arrays' capacity; the last row is unwritten and reads as eos_id)."""
    main, startup = Program(), Program()
    nbk = batch * beam_size
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[batch, src_len], dtype="int64",
                          append_batch_size=False)
        src_emb = layers.embedding(
            src, size=[src_vocab, emb_dim],
            param_attr=ParamAttr(name="src_emb_w"))
        src_tm = layers.transpose(src_emb, [1, 0, 2])
        enc = layers.StaticRNN()
        with enc.step():
            x_t = enc.step_input(src_tm)
            h_p = enc.memory(shape=[hidden], batch_ref=src_tm)
            h = _cell(x_t, h_p, hidden, "enc_cell")
            enc.update_memory(h_p, h)
            enc.step_output(h)
        enc_states = enc()
        enc_final = layers.reshape(
            layers.slice(enc_states, axes=[0], starts=[src_len - 1],
                         ends=[src_len]), [batch, hidden])
        # tile beam copies: [B, H] -> [B*beam, H]
        state = layers.reshape(
            layers.expand(layers.unsqueeze(enc_final, axes=[1]),
                          expand_times=[1, beam_size, 1]), [nbk, hidden])

        ids_arr = layers.create_array("int64")
        sc_arr = layers.create_array("float32")
        par_arr = layers.create_array("int64")

        i = layers.fill_constant([1], "int64", 0)
        # seed entries fix the element shapes so the arrays can enter the
        # While loop as fixed-capacity buffers; step 0 overwrites them
        layers.array_write(layers.fill_constant([nbk, 1], "int64", bos_id),
                           i, ids_arr)
        layers.array_write(layers.fill_constant([nbk, 1], "float32", 0.0),
                           i, sc_arr)
        layers.array_write(layers.fill_constant([nbk], "int64", 0),
                           i, par_arr)
        n = layers.fill_constant([1], "int64", max_len)
        pre_ids = layers.fill_constant([nbk, 1], "int64", bos_id)
        # Only beam slot 0 of each source enters step 0 live; slots 1..K-1
        # start at -1e9 so top-k doesn't select K identical candidates from
        # the K duplicated parent rows (the reference starts with one beam
        # per source via LoD; with dense fixed-width beams the mask does it).
        init_scores = np.where(
            (np.arange(nbk) % beam_size == 0)[:, None], 0.0, -1e9
        ).astype(np.float32)
        pre_scores = layers.assign(init_scores)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_len=max_len + 1)
        with w.block():
            emb = layers.embedding(
                layers.reshape(pre_ids, [nbk]),
                size=[tgt_vocab, emb_dim],
                param_attr=ParamAttr(name="tgt_emb_w"))
            h = _cell(emb, state, hidden, "dec_cell")
            logits = layers.fc(h, tgt_vocab,
                               param_attr=ParamAttr(name="proj_w"),
                               bias_attr=False, name="proj_infer")
            logprob = layers.log_softmax(logits)          # [nbk, V]
            acc = layers.elementwise_add(logprob, pre_scores)
            blk = main.current_block()
            sel_ids = blk.create_var(
                name=f"bs_sel_ids_{id(main)}", shape=(nbk, 1), dtype="int64")
            sel_sc = blk.create_var(
                name=f"bs_sel_sc_{id(main)}", shape=(nbk, 1), dtype="float32")
            parent = blk.create_var(
                name=f"bs_parent_{id(main)}", shape=(nbk,), dtype="int64")
            blk.append_op("beam_search",
                          inputs={"pre_ids": pre_ids,
                                  "pre_scores": pre_scores, "scores": acc},
                          outputs={"selected_ids": sel_ids,
                                   "selected_scores": sel_sc,
                                   "parent_idx": parent},
                          attrs={"beam_size": beam_size, "end_id": eos_id})
            # reorder decoder state by parent beam
            new_h = layers.gather(h, parent)
            layers.assign(new_h, state)
            layers.assign(sel_ids, pre_ids)
            layers.assign(sel_sc, pre_scores)
            layers.array_write(sel_ids, i, ids_arr)
            layers.array_write(sel_sc, i, sc_arr)
            layers.array_write(parent, i, par_arr)
            layers.increment(i, value=1)
            layers.assign(layers.less_than(i, n), cond)

        blk = main.global_block
        s_ids = blk.create_var(name="decoded_ids",
                               shape=(max_len + 1, nbk), dtype="int64")
        s_sc = blk.create_var(name="decoded_scores",
                              shape=(max_len + 1, nbk), dtype="float32")
        blk.append_op("beam_search_decode",
                      inputs={"Ids": ids_arr, "Scores": sc_arr,
                              "ParentIdx": par_arr},
                      outputs={"SentenceIds": s_ids, "SentenceScores": s_sc},
                      attrs={"beam_size": beam_size, "end_id": eos_id})
    return {"main": main, "startup": startup,
            "feeds": ["src_ids"], "fetches": ["decoded_ids",
                                              "decoded_scores"]}

"""The port's language model against the reference, on the CPU.

reduced(mamba2-2.7b), vocab 250 (so the padded-vocab mask is live), on
both sides with the reference's params carried across (``from_jax``).
Port and reference agree to 2e-2 in bf16 and 1e-4 in fp32 compute.
Chunked against one-shot prefill agrees to 2e-2 even in fp32: the carried
conv window is a bf16 cache leaf, as in the reference, so the chunk
boundary rounds the conv halo to bf16.  Greedy token streams are compared
exactly, in fp32 compute.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as J_CFG
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm
from repro.serving.prefill import chunked_prefill as j_chunked_prefill
from repro_torch.configs import mamba2_2p7b as T_CFG
from repro_torch.configs import reduced
from repro_torch.convert import from_jax, to_numpy
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves
from repro_torch.serving.prefill import chunked_prefill

TOL = 2e-2


def _cfgs(compute_dtype="bfloat16"):
    return (dataclasses.replace(j_reduced(J_CFG, vocab=250),
                                compute_dtype=compute_dtype),
            dataclasses.replace(reduced(T_CFG, vocab=250),
                                compute_dtype=compute_dtype))


def _params(jcfg):
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_tree(got, want, tol=TOL):
    """Leaf by leaf; a bf16 cache leaf (the conv window) is held to 1e-2,
    two bf16 roundings, whatever ``tol`` says for the fp32 leaves."""
    g = tree_leaves(got)
    w = [to_numpy(x) if isinstance(x, torch.Tensor)
         else np.asarray(x, np.float32)
         for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        t = max(tol, 1e-2) if a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(to_numpy(a), b, rtol=t, atol=t)


def test_params_match_reference_layout_and_distributions():
    jcfg, tcfg = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray,
                                jlm.init_lm_params(jcfg, jax.random.PRNGKey(0)))
    tp = lm.init_lm_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(to_numpy(tp)))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(to_numpy(tp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    m = tp["segments"][0][0]["mamba"]
    assert float(m["A_log"].min()) >= 0.0
    assert float(m["A_log"].max()) <= math.log(16.0) + 1e-6
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    # normal init: std = scale / sqrt(fan_in) (/2 for normal_out)
    d = tcfg.d_model
    assert abs(float(m["wz"].std()) - 1 / math.sqrt(d)) < 0.1 / math.sqrt(d)
    di = tcfg.ssm.d_inner(d)
    assert abs(float(m["out_proj"].std()) - 0.5 / math.sqrt(di)) \
        < 0.05 / math.sqrt(di)
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_prefill_matches_reference(compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(2, 37, tcfg.vocab_size)
    j_lg, j_cache = jlm.lm_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   jlm.init_lm_cache(jcfg, 2, 64))
    t_lg, t_cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                                  lm.init_lm_cache(tcfg, 2, 64, device="cpu"))
    _close(t_lg, j_lg)
    _close_tree(t_cache["segments"], j_cache["segments"])
    assert t_cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    # padded vocab rows are masked to -1e30 as in the reference
    assert tcfg.padded_vocab > tcfg.vocab_size
    masked = torch.tensor(-1e30, dtype=t_lg.dtype)
    assert torch.all(t_lg[..., tcfg.vocab_size:] == masked)


@pytest.mark.parametrize("chunk", [7, 16])
def test_chunk_parity_and_reference(chunk):
    """Chunked == one-shot (logits, pos, 8-token greedy continuation), and
    the port's chunked prefill matches the reference's (ragged last chunk
    at 7, chunk == SSD chunk at 16)."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg)
    B, L, MS = 2, 21, 40
    toks = _tokens(B, L, tcfg.vocab_size, seed=2)
    t_ref_lg, t_ref_cache = lm.lm_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MS, device="cpu"))
    t_lg, t_cache = chunked_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MS, device="cpu"), chunk_size=chunk)
    _close(t_lg, to_numpy(t_ref_lg))
    assert torch.equal(t_cache["pos"], t_ref_cache["pos"])
    first = torch.argmax(t_ref_lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    a, _ = lm.decode_tokens(tcfg, tp, t_ref_cache, first, 8)
    b, _ = lm.decode_tokens(tcfg, tp, t_cache, first, 8)
    assert torch.equal(a, b)
    j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(toks),
                                      jlm.init_lm_cache(jcfg, B, MS),
                                      chunk_size=chunk)
    _close(t_lg, j_lg, 1e-4)
    _close_tree(t_cache["segments"], j_cache["segments"], 1e-4)


def test_ragged_lengths_match_solo_and_reference():
    """One padded batch of lengths 5/17/9: each row equals a batch-1
    prefill of its own prompt, and the batch equals the reference's."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg)
    MS, lens = 40, [5, 17, 9]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    padded = np.zeros((3, max(lens)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    t_lg, t_cache = chunked_prefill(
        tcfg, tp, torch.from_numpy(padded),
        lm.init_lm_cache(tcfg, 3, MS, device="cpu"), chunk_size=6,
        lengths=lens)
    assert t_cache["pos"].tolist() == lens
    for i, p in enumerate(prompts):
        solo_lg, solo_cache = lm.lm_prefill(
            tcfg, tp, torch.from_numpy(p[None]),
            lm.init_lm_cache(tcfg, 1, MS, device="cpu"))
        _close(t_lg[i], to_numpy(solo_lg[0]))
        row = [tuple({k: v[:, i:i + 1] for k, v in layer.items()}
                     for layer in seg) for seg in t_cache["segments"]]
        _close_tree(row, solo_cache["segments"])
        first = torch.argmax(solo_lg[..., :tcfg.vocab_size], -1).to(
            torch.int32)
        a, _ = lm.decode_tokens(tcfg, tp, solo_cache, first, 6)
        b, _ = lm.decode_tokens(tcfg, tp, {"segments": row,
                                           "pos": t_cache["pos"][i:i + 1]},
                                first, 6)
        assert torch.equal(a, b)
    j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(padded),
                                      jlm.init_lm_cache(jcfg, 3, MS),
                                      chunk_size=6, lengths=lens)
    _close(t_lg, j_lg, 1e-4)
    _close_tree(t_cache["segments"], j_cache["segments"], 1e-4)


def test_decode_tokens_matches_sequential_and_reference():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg)
    toks = _tokens(2, 8, tcfg.vocab_size, seed=3)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              lm.init_lm_cache(tcfg, 2, 32, device="cpu"))
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    seq, c, tok = [], cache, first
    for _ in range(6):
        lg1, c = lm.lm_decode_step(tcfg, tp, tok, c)
        tok = torch.argmax(lg1[..., :tcfg.vocab_size], -1).to(torch.int32)
        seq.append(tok[:, 0])
    fused, f_cache = lm.decode_tokens(tcfg, tp, cache, first, 6)
    assert torch.equal(fused, torch.stack(seq, 1))
    assert torch.equal(f_cache["pos"], c["pos"])
    for a, b in zip(tree_leaves(f_cache["segments"]),
                    tree_leaves(c["segments"])):
        assert torch.equal(a, b)
    j_lg, j_cache = jlm.lm_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   jlm.init_lm_cache(jcfg, 2, 32))
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    j_toks, _ = jlm.decode_tokens(jcfg, jp, j_cache, j_first, 6)
    np.testing.assert_array_equal(np.asarray(j_toks), fused.numpy())

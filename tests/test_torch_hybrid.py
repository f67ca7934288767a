"""The hybrid and dense slice against the reference, on the CPU.

reduced(zamba2-2.7b) (Mamba-2 layers plus the shared attention+MLP block
at every 6th position, 12 layers) and reduced(llama3-8b) (``dense``
layers, GQA 2:1), vocab 250 so the padded-vocab mask is live, fp32
compute, with the reference's params carried across by ``from_jax``.

* Prefill logits and caches (the nested ``attn`` KV leaves included) and
  the engine's token streams against the reference: logits 1e-4 of max
  |logit|, fp32 cache leaves 1e-4, bf16 cache leaves 1e-2 (one bf16
  rounding of values that agree to 1e-4), token streams exactly.
* Chunked against one-shot prefill and mixed-length rows against solo
  rows: logits 2e-2 — the chunked path attends the bf16 KV cache where
  the one-shot path attends the fresh fp32 keys, as in the reference —
  and greedy continuations exactly.
* ``kv_bucket`` against the whole cache: bit-identical.
* Two prefill groups in a row through one ``ChunkedPrefill`` (whose
  template's KV leaves the first group wrote in place) against a fresh
  scheduler: identical tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as J_LLAMA
from repro.configs import reduced as j_reduced
from repro.configs import zamba2_2p7b as J_ZAMBA
from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.prefill import chunked_prefill as j_chunked_prefill
from repro_torch.configs import llama3_8b as T_LLAMA
from repro_torch.configs import reduced
from repro_torch.configs import zamba2_2p7b as T_ZAMBA
from repro_torch.convert import from_jax, to_numpy
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.prefill import ChunkedPrefill, chunked_prefill

ARCHS = {"zamba2": (J_ZAMBA, T_ZAMBA), "llama3": (J_LLAMA, T_LLAMA)}
TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            jbase, tbase = ARCHS[arch]
            jcfg = dataclasses.replace(j_reduced(jbase, vocab=250),
                                       compute_dtype="float32")
            tcfg = dataclasses.replace(reduced(tbase, vocab=250),
                                       compute_dtype="float32")
            jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
            tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
            built[arch] = (jcfg, tcfg, jp, tp)
        return built[arch]
    return get


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    """max |got - want| within ``tol`` times max(1, max |want|): a key that
    lands on a bf16 rounding edge on one side only moves a few logits by
    more than ``tol`` of their own size."""
    g, w = to_numpy(got), np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _close_cache(t_segs, j_segs, tol):
    """Walk both caches by key (the reference's trees sort dict keys, the
    port's keep insertion order); bf16 leaves are held to 1e-2."""
    def walk(t, j):
        assert set(t) == set(j)
        for key in t:
            if isinstance(t[key], dict):
                walk(t[key], j[key])
                continue
            tl = max(tol, 1e-2) if t[key].dtype == torch.bfloat16 else tol
            np.testing.assert_allclose(
                to_numpy(t[key]), np.asarray(j[key], np.float32), rtol=tl,
                atol=tl, err_msg=key)
    assert len(t_segs) == len(j_segs)
    for ts, js in zip(t_segs, j_segs):
        assert len(ts) == len(js)
        for t, j in zip(ts, js):
            walk(t, j)


def _clone(cache):
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


def _row(cache, i):
    return {"segments": tree_map(lambda t: t[:, i:i + 1].clone(),
                                 cache["segments"]),
            "pos": cache["pos"][i:i + 1].clone()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_layout_matches_reference(arch, models):
    """Same leaves, shapes and dtypes; Zamba2's shared-block layers hold
    their KV under "attn"; the shared params exist once."""
    jcfg, tcfg, jp, tp = models(arch)
    jc = jax.tree_util.tree_map(np.asarray, jlm.init_lm_cache(jcfg, 2, 40))
    tc = lm.init_lm_cache(tcfg, 2, 40, device="cpu")
    assert (jax.tree_util.tree_structure(jc)
            == jax.tree_util.tree_structure(to_numpy(tc)))
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(to_numpy(tc))):
        assert a.shape == b.shape
    assert lm.cache_kv_extent(tc) == 40
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, jp)) == jax.tree_util.tree_structure(to_numpy(tp)))
    if arch == "zamba2":
        assert "shared" in tp
        assert "attn" in tc["segments"][0][5]
        assert "attn" not in tc["segments"][0][0]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunked_prefill_matches_reference(arch, models):
    """The whole chunked prefill (ragged last chunk, KV buckets on both
    sides) against the reference's: logits, pos and every cache leaf."""
    jcfg, tcfg, jp, tp = models(arch)
    B, L, MS = 2, 21, 40
    toks = _tokens(B, L, tcfg.vocab_size, seed=2)
    t_lg, t_cache = chunked_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MS, device="cpu"), chunk_size=7)
    j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(toks),
                                      jlm.init_lm_cache(jcfg, B, MS),
                                      chunk_size=7)
    _close(t_lg, j_lg, 1e-4)
    assert t_cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    _close_cache(t_cache["segments"], j_cache["segments"], 1e-4)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunked_matches_one_shot(arch, models):
    _, tcfg, _, tp = models(arch)
    B, L, MS = 2, 21, 40
    toks = torch.from_numpy(_tokens(B, L, tcfg.vocab_size, seed=3))
    ref_lg, ref_cache = lm.lm_prefill(
        tcfg, tp, toks, lm.init_lm_cache(tcfg, B, MS, device="cpu"))
    lg, cache = chunked_prefill(tcfg, tp, toks,
                                lm.init_lm_cache(tcfg, B, MS, device="cpu"),
                                chunk_size=7)
    _close(lg, to_numpy(ref_lg), TOL)
    assert torch.equal(cache["pos"], ref_cache["pos"])
    first = torch.argmax(ref_lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    a, _ = lm.decode_tokens(tcfg, tp, ref_cache, first, 8)
    b, _ = lm.decode_tokens(tcfg, tp, cache, first, 8)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_token_prompt(arch, models):
    """A 1-token prompt prefills one-shot (the reference's one-shot path
    fails on it with attention) as a 1-token chunk does."""
    _, tcfg, _, tp = models(arch)
    tok = torch.tensor([[7]], dtype=torch.int32)
    a, ac = lm.lm_prefill(tcfg, tp, tok,
                          lm.init_lm_cache(tcfg, 1, 16, device="cpu"))
    b, bc = lm.lm_prefill_chunk(tcfg, tp, tok,
                                lm.init_lm_cache(tcfg, 1, 16, device="cpu"))
    _close(a, to_numpy(b), 1e-5)
    assert ac["pos"].tolist() == bc["pos"].tolist() == [1]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mixed_lengths_match_solo(arch, models):
    """One padded batch of lengths 5/17/9: each row equals a batch-1
    prefill of its own prompt, and decodes the same continuation."""
    _, tcfg, _, tp = models(arch)
    MS, lens = 40, [5, 17, 9]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    padded = np.zeros((3, max(lens)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lg, cache = chunked_prefill(tcfg, tp, torch.from_numpy(padded),
                                lm.init_lm_cache(tcfg, 3, MS, device="cpu"),
                                chunk_size=6, lengths=lens)
    assert cache["pos"].tolist() == lens
    for i, p in enumerate(prompts):
        solo_lg, solo_cache = lm.lm_prefill(
            tcfg, tp, torch.from_numpy(p[None]),
            lm.init_lm_cache(tcfg, 1, MS, device="cpu"))
        _close(lg[i], to_numpy(solo_lg[0]), TOL)
        first = torch.argmax(solo_lg[..., :tcfg.vocab_size], -1).to(
            torch.int32)
        a, _ = lm.decode_tokens(tcfg, tp, solo_cache, first, 6)
        b, _ = lm.decode_tokens(tcfg, tp, _row(cache, i), first, 6)
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_tokens_match_reference_and_buckets(arch, models):
    """Greedy streams equal the reference's exactly; a KV bucket gives
    the same tokens and the same cache, bit for bit, and writes through
    to the full cache."""
    jcfg, tcfg, jp, tp = models(arch)
    toks = _tokens(2, 8, tcfg.vocab_size, seed=4)
    MS = 64
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              lm.init_lm_cache(tcfg, 2, MS, device="cpu"))
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    full, full_cache = lm.decode_tokens(tcfg, tp, _clone(cache), first, 6)
    bucketed, b_cache = lm.decode_tokens(tcfg, tp, _clone(cache), first, 6,
                                         kv_bucket=16)
    assert torch.equal(full, bucketed)
    assert torch.equal(full_cache["pos"], b_cache["pos"])
    for a, b in zip(tree_leaves(full_cache["segments"]),
                    tree_leaves(b_cache["segments"])):
        assert a.shape == b.shape and torch.equal(a, b)
    j_lg, j_cache = jlm.lm_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   jlm.init_lm_cache(jcfg, 2, MS))
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    j_toks, _ = jlm.decode_tokens(jcfg, jp, j_cache, j_first, 6)
    np.testing.assert_array_equal(np.asarray(j_toks), full.numpy())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_chunk_bucket_is_bit_identical(arch, models):
    """Two chunks at per-row offsets: a bucket covering them gives the
    unbucketed logits and cache bit for bit."""
    _, tcfg, _, tp = models(arch)
    toks = torch.from_numpy(_tokens(2, 16, tcfg.vocab_size, seed=5))
    lens = torch.tensor([8, 5], dtype=torch.int32)
    out = []
    for bucket in (None, 16):
        cache = lm.init_lm_cache(tcfg, 2, 48, device="cpu")
        lg1, cache = lm.lm_prefill_chunk(tcfg, tp, toks[:, :8], cache,
                                         kv_bucket=bucket)
        lg2, cache = lm.lm_prefill_chunk(tcfg, tp, toks[:, 8:], cache,
                                         lengths=lens, kv_bucket=bucket)
        assert lm.cache_kv_extent(cache) == 48
        out.append((lg1, lg2, cache))
    (a1, a2, ac), (b1, b2, bc) = out
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert ac["pos"].tolist() == [16, 13] == bc["pos"].tolist()
    for a, b in zip(tree_leaves(ac["segments"]), tree_leaves(bc["segments"])):
        assert torch.equal(a, b)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(n)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_streams_match_reference_engine(arch, models):
    """5 ragged requests through 2 slots (fifo): the last three are
    admitted mid-flight at other positions.  Per-request streams equal
    the reference engine's."""
    jcfg, tcfg, jp, tp = models(arch)
    prompts = _prompts(tcfg.vocab_size, (9, 17, 12, 9, 23))
    kw = dict(slots=2, max_seq=64, decode_block=4, chunk_size=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=10))
        teng.submit(Request(rid=i, prompt=p, max_new=10))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert {r.rid: r.out for r in t_done} == j_out


def _group(ch, prompts, cfg, params):
    """Run one group to its end; returns each row's first token and a
    4-token greedy continuation decoded from the group cache."""
    ch.start(prompts, batch=len(prompts))
    first = {}
    done = False
    while not done:
        emitted, done = ch.step()
        for row, tok, _ in emitted:
            first[row] = tok
    cache = ch.group_cache
    toks = torch.tensor([[first[i]] for i in range(len(prompts))],
                        dtype=torch.int32)
    cont, _ = lm.decode_tokens(cfg, params, cache, toks, 4)
    ch.finish()
    return [first[i] for i in range(len(prompts))], cont.tolist()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_template_reuse_reads_no_stale_kv(arch, models):
    """A group of long prompts leaves its KV rows in the reused template;
    a second group of shorter prompts through the same scheduler must
    give the tokens a fresh scheduler gives."""
    _, tcfg, _, tp = models(arch)
    params = lm.prepare_params(tcfg, tp)
    kw = dict(max_seq=48, chunk_size=8)
    long_, short = (_prompts(tcfg.vocab_size, lens, seed=s)
                    for lens, s in (((30, 22), 6), ((9, 14), 7)))
    reused = ChunkedPrefill(tcfg, params, **kw)
    _group(reused, long_, tcfg, params)
    again = _group(reused, short, tcfg, params)
    fresh = _group(ChunkedPrefill(tcfg, params, **kw), short, tcfg, params)
    assert again == fresh

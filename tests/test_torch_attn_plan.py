"""The attention kernels' launch plans and split merge, on the CPU.

The plans are pure Python from shapes (``attn_decode.ops.split_layout``,
``flash.ops.flash_plan`` and ``flash.ops.key_split``), so their block
counts and key coverage are checked here at the four shapes the served
models reach: zamba2-2.7b (32 heads, 32 KV heads, d=80), llama3-8b (32
and 8, d=128), gemma3-1b's global layers (4 and 1, d=256, a 2048-row
bucket) and its local layers (a 512-slot ring).  The flash kernel's tile
walk (``kv_tiles`` in ``csrc/flash.cu``, mirrored here line for line) is
checked against brute-force masks: every key some query of a block sees
lies in a tile the block visits, once.  The decode kernels' split merge,
written out in plain PyTorch (``attn_decode.ref.decode_attention_split_ref``
and ``merge_splits``), is held against the reference's
``decode_attention_pallas`` in interpret mode at split_k 1, 3 and 8:
2e-4 in fp32 (the reference's kernel-test tolerance), 2e-2 of each row's
max |o| in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_decode.kernel import decode_attention_pallas
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode import ref as dec_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref

B = 4
# (label, heads, KV heads, d, keys): decode shapes of the served models
DECODE_SHAPES = {"zamba2-2.7b": (32, 32, 80, 2048),
                 "llama3-8b": (32, 8, 128, 2048),
                 "gemma3-1b global": (4, 1, 256, 2048),
                 "gemma3-1b local": (4, 1, 256, 512)}
# (splits, keys a split, blocks) under the H100 rule
DECODE_PLANS = {"zamba2-2.7b": (3, 704, 384), "llama3-8b": (8, 256, 256),
                "gemma3-1b global": (16, 128, 64),
                "gemma3-1b local": (8, 64, 32)}


@pytest.mark.parametrize("label", list(DECODE_SHAPES))
def test_decode_split_rule_at_served_shapes(label):
    """Block counts, and every key in exactly one split of whole 64-key
    tiles, none empty."""
    h, kvh, d, s = DECODE_SHAPES[label]
    n, per = dec_ops.split_layout(B, kvh, s)
    assert (n, per, B * kvh * n) == DECODE_PLANS[label]
    assert per % dec_ops.TILE == 0
    covered = np.zeros(s, int)
    for i in range(n):
        lo, hi = i * per, min((i + 1) * per, s)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("s", [1, 63, 64, 65, 300, 512, 2047, 2048, 5000])
@pytest.mark.parametrize("split_k", [None, 1, 3, 8, 16])
def test_decode_split_layout_covers_keys_once(s, split_k):
    """Any cache length and split count: splits of whole tiles that cover
    [0, S) once, none empty, at most 16; a split that starts at or past a
    row's valid_len (at most S) is skipped by the kernel, so the live
    splits of valid_len v are the first ceil(v / keys a split)."""
    n, per = dec_ops.split_layout(B, 1, s, split_k)
    assert 1 <= n <= dec_ops.MAX_SPLIT and per % dec_ops.TILE == 0
    assert (n - 1) * per < s <= n * per
    if split_k is not None:
        assert n <= split_k
    for v in (1, min(per, s), min(per + 1, s), s):
        live = [i for i in range(n) if i * per < v]
        assert len(live) == -(-v // per)


@pytest.mark.parametrize("split_k", [0, 17])
def test_decode_split_k_out_of_range_raises(split_k):
    with pytest.raises(ValueError, match="split_k"):
        dec_ops.split_layout(B, 1, 2048, split_k)


# (label, H, KVH, Sq, Skv, d): flash calls of the served models
FLASH_SHAPES = {"gemma3-1b ring chunk": (4, 1, 256, 768, 256),
                "gemma3-1b chunk past the window": (4, 1, 1024, 1536, 256),
                "gemma3-1b global": (4, 1, 256, 2048, 256),
                "llama3-8b": (32, 8, 256, 2048, 128),
                "zamba2-2.7b": (32, 32, 256, 2048, 80),
                "qwen2.5-0.5b": (14, 2, 256, 2048, 64),
                "phi-3-mini": (32, 32, 256, 2048, 96)}
# (route, heads packed, positions a block, query tiles, splits, blocks)
FLASH_PLANS = {"gemma3-1b ring chunk": ("wgmma", 4, 32, 8, 4, 128),
               "gemma3-1b chunk past the window": ("wgmma", 4, 32, 32, 1,
                                                   128),
               "gemma3-1b global": ("wgmma", 4, 32, 8, 4, 128),
               "llama3-8b": ("wgmma", 4, 32, 8, 1, 256),
               "zamba2-2.7b": ("wgmma", 1, 128, 2, 1, 256),
               # a group of 7 is not packed; 112 tiles already take 112
               # SMs, so one split
               "qwen2.5-0.5b": ("wgmma", 1, 128, 2, 1, 112),
               "phi-3-mini": ("wgmma", 1, 128, 2, 1, 256)}


@pytest.mark.parametrize("label", list(FLASH_SHAPES))
def test_flash_plan_at_served_shapes(label):
    """Head packing and key splits fill at least 128 of the 132 SMs at
    gemma3-1b's one KV head; no split where the tiles alone fill the
    card."""
    h, kvh, sq, skv, d = FLASH_SHAPES[label]
    p = flash_ops.flash_plan(B, h, kvh, sq, skv, d, torch.bfloat16)
    assert (p.route, p.heads_packed, p.positions, p.q_tiles, p.splits,
            p.blocks) == FLASH_PLANS[label]
    assert p.head_groups * p.heads_packed == h
    assert p.blocks == B * p.q_tiles * p.head_groups * p.splits
    assert p.positions * p.q_tiles >= sq
    assert p.splits <= -(-skv // flash_ops.KEY_TILE)


def test_flash_plan_routes_and_forced_choices():
    """fp32 keeps one head and no split; forced choices are checked."""
    p = flash_ops.flash_plan(B, 4, 1, 256, 768, 256, torch.float32)
    assert (p.route, p.heads_packed, p.splits) == ("fp32", 1, 1)
    p = flash_ops.flash_plan(3, 8, 2, 70, 200, 128, torch.bfloat16,
                             heads_packed=1, splits=3)
    assert (p.heads_packed, p.positions, p.head_groups, p.splits,
            p.blocks) == (1, 128, 8, 3, 3 * 8 * 3)
    # a GQA group of 3 is not packed
    assert flash_ops.flash_plan(1, 6, 2, 64, 64, 128,
                                torch.bfloat16).heads_packed == 1
    for kw in ({"heads_packed": 3}, {"splits": 9}, {"splits": 0}):
        with pytest.raises(ValueError):
            flash_ops.flash_plan(B, 8, 2, 256, 512, 128, torch.bfloat16,
                                 **kw)
    with pytest.raises(ValueError, match="wgmma route"):
        flash_ops.flash_plan(B, 8, 2, 256, 512, 80, torch.float32,
                             splits=2)


@pytest.mark.parametrize("splits", range(1, flash_ops.MAX_SPLIT + 1))
def test_key_split_covers_each_tile_once(splits):
    """Every tile of a query tile's list in exactly one split: contiguous
    ranges of whole tiles, at least two each (one split takes all of a
    shorter list), sizes within one of each other, and the splits past
    the active ones empty."""
    for n in range(0, 41):
        ranges = [flash_ops.key_split(n, splits, s) for s in range(splits)]
        active = [r for r in ranges if r[1] > r[0]]
        assert len(active) == max(1, min(splits, n // 2)) or n == 0
        assert ranges[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert ranges[-1][1] == n
        sizes = [hi - lo for lo, hi in active]
        if sizes:
            assert max(sizes) - min(sizes) <= 1
            assert min(sizes) >= min(2, n)


def kv_tiles(wrap, qa, qb, tile, *, skv, causal, window, ring_len):
    """``kv_tiles`` and ``tile_at`` of csrc/flash.cu: the KV tiles a block
    of queries at positions [qa, qb] walks, in order."""
    if ring_len is None:
        hi = min(skv, qb + 1) if causal else skv
        lo = max(0, qa - window + 1) if window else 0
        end = -(-hi // tile) if hi > 0 else 0
        return list(range(lo // tile, max(lo // tile, end)))
    ring = min(ring_len, skv)
    ring_keys = ring if wrap >= window else max(0, min(ring, wrap))
    ring_live = ring_keys if wrap - 1 > qa - window else 0
    n_head = -(-ring_live // tile)
    tail_hi = min(skv, ring + qb - wrap + 1)
    tail_lo = max(ring, ring + qa - window + 1 - wrap)
    end = -(-tail_hi // tile) if tail_hi > ring else 0
    t_tail = max(tail_lo // tile, n_head)
    return list(range(n_head)) + list(range(t_tail, max(t_tail, end)))


def _seen_keys(qpos, skv, *, causal, window, wrap=None, ring_len=None):
    """Key slots each query position sees, by the plain version's masks."""
    if ring_len is not None:
        kpos = flash_ref.ring_kv_positions(torch.tensor([wrap]), window,
                                           ring_len, skv)[0].long()
        ok = kpos >= 0
    else:
        kpos = torch.arange(skv)
        ok = torch.ones(skv, dtype=torch.bool)
    q = torch.as_tensor(qpos)[:, None]
    if causal:
        ok = ok & (q >= kpos)
    if window:
        ok = ok & ((q - kpos) < window)
    return ok.any(0)


@pytest.mark.parametrize("layout", ["plain", "window", "ring"])
def test_kv_tile_walk_visits_every_seen_key_once(layout):
    """Over query blocks of 32 positions (gemma3-1b's packed blocks) and
    64-key tiles, at gemma3-1b's window 512 and cursors before, at and
    past the wrap: the walk visits each tile once and misses no key that
    a query of the block sees, ring and window skips included."""
    rng = np.random.default_rng(0)
    tile, npos, window = 64, 32, 512
    for _ in range(60):
        if layout == "ring":
            ring_len = int(rng.choice([256, 384, 512]))
            sq = int(rng.choice([128, 256, 1024]))
            wrap = int(rng.choice([0, 100, 300, 511, 512, 700, 1792]))
            skv, off, kw = ring_len + sq, wrap, dict(
                causal=True, window=window, ring_len=ring_len)
        else:
            sq, skv = 256, 2048
            wrap, off = 0, int(rng.choice([0, 512, 1024, 1792]))
            kw = dict(causal=True, window=window if layout == "window"
                      else None, ring_len=None)
        for q0 in range(0, sq, npos):
            qa, qb = off + q0, off + min(q0 + npos, sq) - 1
            tiles = kv_tiles(wrap, qa, qb, tile, skv=skv, **kw)
            assert len(set(tiles)) == len(tiles)
            seen = _seen_keys(range(qa, qb + 1), skv, wrap=wrap, **kw)
            visited = torch.zeros(skv, dtype=torch.bool)
            for t in tiles:
                visited[t * tile:(t + 1) * tile] = True
            assert not bool((seen & ~visited).any()), (layout, wrap, qa)


def _qkv(seed, b, h, kvh, s, d, dtype):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, d), (b, kvh, s, d), (b, kvh, s, d))]
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("split_k", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_pallas(split_k, dtype):
    """The kernels' split-and-merge arithmetic against the reference's
    split-K Pallas kernel (interpret mode) at the same split count, on a
    512-slot cache with a GQA group of 4 and valid lengths on and off the
    split edges (one row's later splits empty)."""
    b, h, kvh, s, d = 4, 8, 2, 512, 16
    (jq, jk, jv), (tq, tk, tv) = _qkv(split_k, b, h, kvh, s, d, dtype)
    vl = np.array([1, 64, 301, 512], np.int32)
    _, per = dec_ops.split_layout(b, kvh, s, split_k)
    got = dec_ref.decode_attention_split_ref(
        tq, tk, tv, valid_len=torch.from_numpy(vl), split_len=per)
    want = decode_attention_pallas(jq, jk, jv, valid_len=jnp.asarray(vl),
                                   block_s=64, split_k=split_k,
                                   interpret=True)
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(g - w).max(-1)
        assert (err <= 2e-2 * np.abs(w).max(-1)).all()


def test_merge_splits_drops_empty_splits():
    """A split with no live key (m = -1e30, l = 0) leaves the merge as it
    was; a single split is its own normalised output."""
    r = np.random.default_rng(1)
    acc = torch.from_numpy(r.standard_normal((3, 2, 5)).astype(np.float32))
    m = torch.tensor([[0.5, 2.0], [1.0, -1e30], [-1e30, 3.0]])
    lsum = torch.tensor([[2.0, 3.0], [1.5, 0.0], [0.0, 4.0]])
    acc[1, 1] = 0.0
    acc[2, 0] = 0.0
    got = dec_ref.merge_splits(acc, m, lsum)
    torch.testing.assert_close(got[1], acc[1, 0] / 1.5)
    torch.testing.assert_close(got[2], acc[2, 1] / 4.0)
    w = torch.exp(m[0] - 2.0)
    torch.testing.assert_close(
        got[0], (acc[0] * w[:, None]).sum(0) / (lsum[0] * w).sum())


@pytest.mark.parametrize("sq,d,ring,rows", [
    (1500, 80, False, 192), (1500, 96, False, 192), (1536, 128, False, 128),
    (1500, 80, True, 128), (1500, 256, False, 128), (1500, 32, False, 128),
    (256, 80, False, 128), (2048, 80, False, 128), (1088, 64, False, 192)])
def test_flash_plan_wide_blocks(sq, d, ring, rows):
    """192-row blocks (three consumer warpgroups) at hubert-xlarge's
    encoder shape (B=4, 16 heads on 16, 1500 frames: 8 tiles of 192, not
    12 of 128) and wherever they pad no more query rows than 128-row
    blocks and still give every SM a tile, at a head dim built with them
    and without a ring; a served chunk of 256 and a training sequence of
    2048 keep 128, and so does d = 128 (not built with them)."""
    p = flash_ops.flash_plan(B, 16, 16, sq, sq, d, torch.bfloat16,
                             ring=ring)
    assert p.rows == rows
    assert p.positions == rows and p.q_tiles == -(-sq // rows)
    assert p.blocks == B * 16 * p.q_tiles * p.splits


def test_flash_plan_forced_rows():
    """Forced 192-row blocks need a head dim built with them and no ring;
    the fp32 route takes 128 only."""
    p = flash_ops.flash_plan(2, 8, 2, 500, 900, 80, torch.bfloat16,
                             heads_packed=4, rows=192)
    assert (p.rows, p.positions, p.q_tiles) == (192, 48, 11)
    for kw in (dict(rows=256), dict(rows=192, ring=True)):
        with pytest.raises(ValueError, match="rows"):
            flash_ops.flash_plan(2, 8, 2, 500, 900, 80, torch.bfloat16, **kw)
    with pytest.raises(ValueError, match="rows"):
        flash_ops.flash_plan(2, 8, 2, 500, 900, 256, torch.bfloat16,
                             rows=192)
    with pytest.raises(ValueError, match="wgmma route"):
        flash_ops.flash_plan(2, 8, 2, 500, 900, 80, torch.float32, rows=192)

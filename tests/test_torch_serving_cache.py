"""The port's cache administration, blob format and memory model against
the reference's, on the CPU.

* ``core.memmodel``: every function equal to the reference's for every
  registered config (its ``hybrid_par`` gap included).
* ``slot_schema``: equal to the reference's, key, shape and dtype, for the
  fault-matrix archs and reduced zamba2-2.7b, gemma3-1b, falcon-h1-0.5b,
  mamba-130m and llama3-8b.
* Blobs: the same rows in an fp32 or a bf16 cache give the reference's
  blob: keys, payload bytes, the ``__meta__`` record (schema,
  fingerprint, crc, live prefix, tags) character for character, and the
  ``dump_blob`` file byte for byte; ``offload_slots`` gives
  ``offload_slot``'s blobs.
* Damage: a bit flip, a key-set difference, a dtype drift, a wrong tag,
  a tampered fingerprint or live prefix raise ``CacheCorruption`` with
  the reference's message, naming the key.
* ``restore_slot`` writes the slot in place (every leaf keeps its
  ``data_ptr``), bit-exactly, and leaves the other slots alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as j_reduced
from repro.core import memmodel as jmem
from repro.core.registry import get as j_get
from repro.models import lm as jlm
from repro.serving import cache as jcache_mod
from repro.serving import store as jstore
from repro.serving.faults import CacheCorruption as JCacheCorruption
from repro_torch.configs import reduced
from repro_torch.convert import to_numpy
from repro_torch.core import memmodel as tmem
from repro_torch.core.registry import get as t_get
from repro_torch.core.registry import list_archs
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves
from repro_torch.serving import cache as tcache_mod
from repro_torch.serving import store as tstore
from repro_torch.serving.faults import CacheCorruption
from tests.test_torch_faults import ARCHS, setup_pair

REGISTERED = list_archs()
REDUCED = ("zamba2-2.7b", "gemma3-1b", "falcon-h1-0.5b", "mamba-130m",
           "llama3-8b")


# ----------------------------------------------------------- memory model

@pytest.mark.parametrize("name", REGISTERED)
def test_memmodel_equals_reference(name):
    tc, jc = t_get(name), j_get(name)
    assert tmem.param_count(tc) == jc.param_count()
    for b, s in ((1, 512), (4, 4096)):
        assert tmem.kv_cache_bytes(tc, b, s) == jmem.kv_cache_bytes(jc, b, s)
        assert tmem.ssm_state_bytes(tc, b) == jmem.ssm_state_bytes(jc, b)
        assert tcache_mod.cache_bytes(tc, b, s) == \
            jcache_mod.cache_bytes(jc, b, s)
        for kw in ({}, {"logits_mode": "last"}, {"eager_attention": True}):
            assert tmem.activation_bytes(tc, b, s, **kw) == \
                jmem.activation_bytes(jc, b, s, **kw)
            assert tmem.inference_memory(tc, b, s, **kw).as_dict() == \
                jmem.inference_memory(jc, b, s, **kw).as_dict()
    assert tmem.weight_bytes(tc) == jmem.weight_bytes(jc)
    assert tmem.max_seq_len(tc, 24e9) == jmem.max_seq_len(jc, 24e9)
    assert tcache_mod.max_slots(tc, 4096, 80e9, 6e9) == \
        jcache_mod.max_slots(jc, 4096, 80e9, 6e9)


def test_memmodel_hybrid_par_gap_is_the_references():
    """The reference counts no ``hybrid_par`` layer in its KV and state
    bytes; the port computes the same (ROADMAP.md §3)."""
    tc = t_get("falcon-h1-0.5b")
    assert tmem.kv_cache_bytes(tc, 1, 4096) == 0
    assert tmem.ssm_state_bytes(tc, 1) == 0
    assert tcache_mod.cache_bytes(tc, 1, 4096) == 0


# ------------------------------------------------------------ slot schema

def _cfg_pair(name):
    if name in ARCHS:
        jc, tc, _, _ = setup_pair(name)
        return jc, tc
    return j_reduced(j_get(name)), reduced(t_get(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS + REDUCED)
def test_slot_schema_equals_reference(name, dtype):
    jc, tc = _cfg_pair(name)
    tcache = lm.init_lm_cache(tc, 3, 64, dtype=getattr(torch, dtype),
                              device="cpu")
    jcache = jlm.init_lm_cache(jc, 3, 64, dtype=getattr(jnp, dtype))
    got = tcache_mod.slot_schema(tcache)
    assert got == jcache_mod.slot_schema(jcache)
    assert list(got) == sorted(got)
    keys = [k for k, _ in tcache_mod.leaves_with_path(tcache)]
    assert keys == ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path)
                    for path, _ in jax.tree_util.tree_leaves_with_path(
                        jcache)]


# ------------------------------------------------------------------ blobs

def _filled(name, dtype, pos=(5, 17, 30), seed=0):
    """A port cache and a reference cache holding the same random rows
    (each leaf in its own dtype) and positions."""
    jc, tc = _cfg_pair(name)
    b = len(pos)
    tcache = lm.init_lm_cache(tc, b, 32, dtype=getattr(torch, dtype),
                              device="cpu")
    rng = np.random.default_rng(seed)
    for t in tree_leaves(tcache["segments"]):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
            np.float32)).to(t.dtype))
    tcache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
    vals = dict(tcache_mod.leaves_with_path(to_numpy(tcache)))
    j0 = jlm.init_lm_cache(jc, b, 32, dtype=getattr(jnp, dtype))
    jcache = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jnp.asarray(vals["/".join(
            str(getattr(q, "key", getattr(q, "idx", q))) for q in p)]
        ).astype(leaf.dtype), j0)
    return tcache, jcache


def _raw(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return tcache_mod._raw_bytes(a).tobytes()
    return np.ascontiguousarray(a).tobytes()


def _dtype(a) -> str:
    """The schema's dtype name of a port tensor or a reference array."""
    if isinstance(a, torch.Tensor):
        return tcache_mod.dtype_name(a)
    return str(a.dtype)


def _same_blob(tblob, want):
    """``tblob`` (the port's) equals ``want`` (the reference's or the
    port's): keys in order, dtype names, shapes, bytes and meta."""
    assert list(tblob) == list(want)
    for k, v in tblob.items():
        if k == tcache_mod.BLOB_META_KEY:
            assert v == want[k]
        else:
            assert tcache_mod.dtype_name(v) == _dtype(want[k])
            assert tuple(v.shape) == tuple(want[k].shape)
            assert _raw(v) == _raw(want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS + ("zamba2-2.7b", "gemma3-1b",
                                          "falcon-h1-0.5b"))
def test_blob_equals_reference(name, dtype):
    tcache, jcache = _filled(name, dtype)
    tags = {"rid": 7, "priority": 1}
    tblob = tcache_mod.offload_slot(tcache, 1, tags=tags)
    jblob = jcache_mod.offload_slot(jcache, 1, tags=tags)
    _same_blob(tblob, jblob)
    assert tstore.dump_blob(tblob) == jstore.dump_blob(jblob)
    # several slots at once: the same blobs, slot for slot
    tb = tcache_mod.offload_slots(tcache, [2, 0], tags={2: tags})
    jb = jcache_mod.offload_slots(jcache, [2, 0], tags={2: tags})
    for b in (0, 2):
        _same_blob(tb[b], jb[b])
    _same_blob(tb[0], tcache_mod.offload_slot(tcache, 0))
    assert tcache_mod.slot_schema(tcache) == \
        tcache_mod._blob_schema({k: v for k, v in tblob.items()
                                 if k != tcache_mod.BLOB_META_KEY})


def test_live_prefix_crc_bounds_shared_attention_only():
    """zamba2's shared attention (``attn/k``, ``attn/v``) is crc'd over the
    slot's first ``pos`` rows: a change past them passes validation; a
    flat ``k`` (dense) is crc'd whole."""
    for name, live in (("hybrid", True), ("dense", False)):
        tcache, _ = _filled(name, "float32")
        blob = tcache_mod.offload_slot(tcache, 0)        # pos 5
        key = next(k for k in blob if k.endswith("k") and "/" in k)
        assert ("live" in blob[tcache_mod.BLOB_META_KEY]) == live
        blob[key] = blob[key].clone()
        blob[key][:, :, 20] += 1.0
        keys = list(tcache_mod.slot_schema(tcache))
        if live:
            tcache_mod.validate_blob(blob, keys)
        else:
            with pytest.raises(CacheCorruption, match="crc32"):
                tcache_mod.validate_blob(blob, keys)


def _damage(kind, blob, np_side):
    """Apply one kind of damage to a blob (numpy values on the reference
    side, tensors on the port's)."""
    meta = tcache_mod.BLOB_META_KEY
    key = sorted(k for k in blob if k != meta and k != "pos")[0]
    out = dict(blob)
    if kind == "bitflip":
        a = np.array(out[key]) if np_side else out[key].clone()
        raw = a.view(np.uint8).reshape(-1) if np_side else \
            a.reshape(-1).view(torch.uint8)
        raw[3] ^= 4
        out[key] = a
    elif kind == "keyset":
        del out[key]
        out["bogus/leaf"] = (np.zeros(3, np.float32) if np_side
                             else torch.zeros(3))
    elif kind == "dtype":
        out[key] = (out[key].astype(np.float64) if np_side
                    else out[key].double())
    elif kind == "fingerprint":
        out[meta] = out[meta].replace('"fingerprint": "',
                                      '"fingerprint": "0')
    elif kind == "meta":
        out[meta] = out[meta][:-3]
    elif kind == "live":
        out[meta] = out[meta].replace('"live": {', '"live": {"pos": 3, ')
    return out, key


@pytest.mark.parametrize("kind", ["bitflip", "keyset", "dtype",
                                  "fingerprint", "meta", "live"])
def test_damage_raises_the_references_corruption(kind):
    tcache, jcache = _filled("hybrid", "float32")
    tblob, tkey = _damage(kind, tcache_mod.offload_slot(tcache, 2), False)
    jblob, jkey = _damage(kind, jcache_mod.offload_slot(jcache, 2), True)
    assert tkey == jkey
    with pytest.raises(CacheCorruption) as got:
        tcache_mod.restore_slot(tcache, tblob, 1, rid=7)
    with pytest.raises(JCacheCorruption) as want:
        jcache_mod.restore_slot(jcache, jblob, 1, rid=7)
    assert str(got.value) == str(want.value)
    assert got.value.key == want.value.key
    if kind in ("bitflip", "dtype"):
        assert tkey in str(got.value) and "rid=7" in str(got.value)
    if kind == "keyset":
        assert "missing=" in str(got.value) and "bogus/leaf" in str(got.value)


def test_restore_checks_identity_tags():
    tcache, _ = _filled("hybrid", "float32")
    blob = tcache_mod.offload_slot(tcache, 0, tags={"rid": 3})
    with pytest.raises(CacheCorruption, match="identity tag 'rid'"):
        tcache_mod.restore_slot(tcache, blob, 1, expect_tags={"rid": 4})
    tcache_mod.restore_slot(tcache, blob, 1, expect_tags={"rid": 3})
    assert tcache_mod.blob_tags(blob) == {"rid": 3}
    # a blob without meta: the key-set check alone, and no tags
    del blob[tcache_mod.BLOB_META_KEY]
    assert tcache_mod.blob_tags(blob) == {}
    tcache_mod.restore_slot(tcache, blob, 2, expect_tags={"rid": 9})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS + ("gemma3-1b",))
def test_restore_in_place_keeps_addresses(name, dtype):
    """Slot 0's blob restored into slot 2: every leaf keeps its address,
    slot 2 holds slot 0's rows bit for bit, slots 0 and 1 are untouched,
    and the restored blob's offload is the original blob."""
    tcache, _ = _filled(name, dtype)
    blob = tcache_mod.offload_slot(tcache, 0)
    before = [t.clone() for t in tree_leaves(tcache["segments"])]
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    assert tcache_mod.restore_slot(tcache, blob, 2) is tcache
    assert [t.data_ptr() for t in tree_leaves(tcache)] == ptrs
    for now, old in zip(tree_leaves(tcache["segments"]), before):
        assert torch.equal(now[:, 2], old[:, 0])
        assert torch.equal(now[:, :2], old[:, :2])
    assert tcache["pos"].tolist() == [5, 17, 5]
    again = tcache_mod.offload_slot(tcache, 2)
    _same_blob(again, blob)


def test_restore_rejects_a_blob_of_another_geometry():
    tcache, _ = _filled("dense", "float32")
    small = lm.init_lm_cache(setup_pair("dense")[1], 2, 16,
                             dtype=torch.float32, device="cpu")
    blob = tcache_mod.offload_slot(small, 0)
    with pytest.raises(CacheCorruption, match="schema|fit"):
        tcache_mod.restore_slot(tcache, blob, 0)


def test_extract_insert_roundtrip():
    tcache, _ = _filled("hybrid", "bfloat16")
    one = tcache_mod.extract_slot(tcache, 1)
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    assert tcache_mod.insert_slot(tcache, one, 0) is tcache
    assert [t.data_ptr() for t in tree_leaves(tcache)] == ptrs
    for t in tree_leaves(tcache["segments"]):
        assert torch.equal(t[:, 0], t[:, 1])
    assert tcache["pos"].tolist() == [17, 17, 30]

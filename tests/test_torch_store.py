"""The port's durable checkpoint store against the reference's, on the CPU.

* ``layout_fingerprint`` equals the reference's for the same config and
  cache; ``dump_blob`` / ``parse_blob`` round-trip fp32 and bf16 blobs,
  read the reference's files (bf16 included) and reject torn or foreign
  files as the reference does; ``CheckpointStore`` stages, commits,
  retains and prunes.
* Kill points 0 and 1 (the reference's four ``kill`` specs on the hybrid
  fault-matrix config, fp32): the crashed engine plus a fresh engine over
  its store decode exactly the reference engine's uninterrupted streams,
  with the reference's recovery outcomes.
* A torn blob replays from the prompt, a torn manifest cold-starts, a
  foreign fingerprint is refused, a tampered prompt is unrecoverable, and
  deadlines survive a restart as the remaining budget (the reference
  tests' own assertions, same fake clock).
"""
import json

import numpy as np
import pytest
import torch

from repro.serving import store as jstore
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.fault_inject import FaultPlan as JFaultPlan
from repro.serving.fault_inject import SimulatedCrash as JSimulatedCrash
from repro.serving.cache import offload_slot as j_offload_slot
from repro.serving.cache import slot_schema as j_slot_schema
from repro_torch.serving import store as tstore
from repro_torch.serving.cache import (BLOB_META_KEY, offload_slot,
                                       slot_schema, validate_blob)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.fault_inject import FaultPlan, SimulatedCrash
from repro_torch.serving.faults import (CacheCorruption, DeadlineExceeded,
                                        RecoveryFailed)
from tests.test_torch_faults import (ARCHS, FakeClock, fp32_caches,  # noqa
                                     prompts_for, setup_pair)
from tests.test_torch_serving_cache import _filled, _same_blob

KILL_SPECS = {
    "mid_prefill": "kill@iter=1",
    "mid_decode": "kill@iter=2",
    "ckpt_manifest_gap": "kill@iter=2:point=1",
    "post_completion": "kill@iter=4",
}
MAX_NEW = (6, 24)
ENG_KW = dict(slots=2, max_seq=48, decode_block=4, chunk_size=8,
              checkpoint_every=2)


# ------------------------------------------------------- blob container

@pytest.mark.parametrize("name", ARCHS + ("gemma3-1b", "falcon-h1-0.5b"))
def test_layout_fingerprint_equals_reference(name):
    tcache, jcache = _filled(name, "bfloat16")
    assert slot_schema(tcache) == j_slot_schema(jcache)
    assert tstore.layout_fingerprint(name, 32, slot_schema(tcache)) == \
        jstore.layout_fingerprint(name, 32, j_slot_schema(jcache))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_container_roundtrip_and_reference_files(name, dtype):
    """The port's file is the reference's file; each side parses the
    other's, and the parsed blob validates and equals the offloaded one."""
    tcache, jcache = _filled(name, dtype)
    tblob = offload_slot(tcache, 2, tags={"rid": 4})
    jblob = j_offload_slot(jcache, 2, tags={"rid": 4})
    data = tstore.dump_blob(tblob)
    assert data == jstore.dump_blob(jblob)
    back = tstore.parse_blob(data)
    _same_blob(back, tblob)
    validate_blob(back, list(slot_schema(tcache)), rid=4)
    assert any(v.dtype == getattr(torch, dtype) for k, v in back.items()
               if k != BLOB_META_KEY)
    _same_blob(tstore.parse_blob(jstore.dump_blob(jblob)), jblob)


@pytest.mark.parametrize("cut", ["magic", "header_len", "header", "payload",
                                 "version", "dtype"])
def test_container_rejects_damage(cut):
    tcache, _ = _filled("hybrid", "bfloat16")
    data = tstore.dump_blob(offload_slot(tcache, 0))
    hlen = int.from_bytes(data[10:18], "little")
    if cut == "magic":
        bad = b"X" + data[1:]
    elif cut == "header_len":
        bad = data[:14]
    elif cut == "header":
        bad = data[:18 + hlen // 2]
    elif cut == "payload":
        bad = data[:-7]
    elif cut == "version":
        bad = data.replace(b'"version": 1', b'"version": 9', 1)
    else:
        bad = data.replace(b'"bfloat16"', b'"bfloat17"', 1)
    with pytest.raises(CacheCorruption, match="durable blob"):
        tstore.parse_blob(bad)
    with pytest.raises(Exception, match="durable blob"):
        jstore.parse_blob(bad)


def test_store_stage_commit_retain_prune(tmp_path):
    tcache, _ = _filled("hybrid", "float32")
    st = tstore.CheckpointStore(str(tmp_path), retain=2)
    rels = [st.stage_blob(3, offload_slot(tcache, b)) for b in (0, 1, 2)]
    assert st.requests["3"]["blobs"] == rels[::-1][:2]
    st.record(3, state="live", pos=5)
    st.commit()
    files = sorted(p.name for p in (tmp_path / "blobs").iterdir())
    assert files == sorted(r.split("/")[1] for r in rels[1:])
    again = tstore.CheckpointStore(str(tmp_path))
    assert again.requests["3"]["pos"] == 5 and again.rids() == [3]
    assert again._seq == 3                    # never reuses a file name
    _same_blob(again.load_blob(rels[2]), offload_slot(tcache, 2))
    again.forget(3)
    again.commit()
    assert not list((tmp_path / "blobs").iterdir())
    with pytest.raises(CacheCorruption, match="unreadable"):
        again.load_blob(rels[2])


# ---------------------------------------------------------- kill matrix

def _prompts():
    return prompts_for(setup_pair("hybrid")[1].vocab_size)


def _reference_out():
    jc, _, jp, _ = setup_pair("hybrid")
    eng = JEngine(jc, jp, **ENG_KW)
    for i, p in enumerate(_prompts()):
        eng.submit(JRequest(rid=i, prompt=p, max_new=MAX_NEW[i]))
    eng.run(max_iters=300)
    return {r.rid: list(r.out) for r in eng.finished}, eng._decode_n


def _port(store=None, spec="", clock=None):
    _, tc, _, tp = setup_pair("hybrid")
    return ServingEngine(tc, tp, fault_plan=FaultPlan.from_spec(spec),
                         store=store, clock=clock, device="cpu", **ENG_KW)


def _submit(eng, make, deadline_ms=None, rids=(0, 1)):
    for i, p in enumerate(_prompts()):
        if i in rids:
            eng.submit(make(rid=i, prompt=p, max_new=MAX_NEW[i],
                            deadline_ms=deadline_ms))


def _crash_restart(make_engine, make_req, crash, spec, root):
    eng1 = make_engine(tstore.CheckpointStore(root) if make_req is Request
                       else jstore.CheckpointStore(root), spec)
    _submit(eng1, make_req)
    with pytest.raises(crash):
        eng1.run(max_iters=300)
    eng2 = make_engine(tstore.CheckpointStore(root) if make_req is Request
                       else jstore.CheckpointStore(root), "")
    recovery = dict(eng2.recovery)
    eng2.run(max_iters=300)
    out = {r.rid: list(r.out) for r in eng1.finished if r.status == "ok"}
    out.update({r.rid: list(r.out) for r in eng2.finished})
    assert all(r.status == "ok" for r in eng2.finished)
    return out, recovery


@pytest.mark.parametrize("point", sorted(KILL_SPECS))
def test_kill_point_recovers_like_reference(point, tmp_path, fp32_caches):
    want, decode_n = _reference_out()
    jc, tc, jp, tp = setup_pair("hybrid")

    def j_engine(store, spec):
        eng = JEngine(jc, jp, store=store,
                      fault_plan=JFaultPlan.from_spec(spec), **ENG_KW)
        eng._decode_n = decode_n
        return eng
    got, rec = _crash_restart(lambda st, sp: _port(st, sp), Request,
                              SimulatedCrash, KILL_SPECS[point],
                              str(tmp_path / "t"))
    j_got, j_rec = _crash_restart(j_engine, JRequest, JSimulatedCrash,
                                  KILL_SPECS[point], str(tmp_path / "j"))
    assert got == want and j_got == want
    assert rec == j_rec
    if point in ("mid_decode", "ckpt_manifest_gap"):
        assert rec["restored"] >= 1
    # the manifests agree on every record but its clock fields
    drop = ("t", "age_ms", "blobs")
    t_man = json.loads((tmp_path / "t" / "manifest.json").read_text())
    j_man = json.loads((tmp_path / "j" / "manifest.json").read_text())
    strip = lambda m: {k: {f: v for f, v in r.items() if f not in drop}  # noqa
                       for k, r in m["requests"].items()}
    assert strip(t_man) == strip(j_man)
    assert t_man["fingerprint"] == j_man["fingerprint"]


def _crashed_store(tmp_path, spec="kill@iter=2", clock=None, **submit_kw):
    root = str(tmp_path / "store")
    eng = _port(tstore.CheckpointStore(root), spec, clock=clock)
    _submit(eng, Request, **submit_kw)
    with pytest.raises(SimulatedCrash):
        eng.run(max_iters=300)
    return tmp_path / "store"


def test_torn_blob_replays_from_prompt(tmp_path, fp32_caches):
    want, _ = _reference_out()
    store_dir = _crashed_store(tmp_path)
    blobs = list((store_dir / "blobs").glob("*.blob"))
    assert blobs
    for f in blobs:
        f.write_bytes(f.read_bytes()[:max(1, f.stat().st_size // 2)])
    eng = _port(tstore.CheckpointStore(str(store_dir)))
    assert eng.recovery["replayed"] >= 1 and eng.recovery["restored"] == 0
    eng.run(max_iters=300)
    assert {r.rid: list(r.out) for r in eng.finished} == want


def test_torn_manifest_cold_starts(tmp_path, fp32_caches):
    store_dir = _crashed_store(tmp_path)
    (store_dir / tstore.MANIFEST_NAME).write_bytes(b'{"version": 1, "requ')
    eng = _port(tstore.CheckpointStore(str(store_dir)))
    assert sum(eng.recovery.values()) == 0
    _submit(eng, Request)
    eng.run(max_iters=300)
    assert all(r.status == "ok" for r in eng.finished)


def test_foreign_fingerprint_refused(tmp_path, fp32_caches):
    store_dir = _crashed_store(tmp_path)
    _, tc, _, tp = setup_pair("dense")
    other = ServingEngine(tc, tp, store=tstore.CheckpointStore(
        str(store_dir)), device="cpu", **ENG_KW)
    assert other.store is None and sum(other.recovery.values()) == 0
    again = _port(tstore.CheckpointStore(str(store_dir)))
    assert sum(again.recovery.values()) == 2


def test_tampered_prompt_is_unrecoverable(tmp_path, fp32_caches):
    store_dir = _crashed_store(tmp_path)
    man_path = store_dir / tstore.MANIFEST_NAME
    man = json.loads(man_path.read_text())
    man["requests"]["0"]["prompt"][0] += 1
    man_path.write_text(json.dumps(man))
    eng = _port(tstore.CheckpointStore(str(store_dir)))
    assert eng.recovery["unrecoverable"] == 1
    (bad,) = [r for r in eng.finished if r.rid == 0]
    assert bad.status == "failed" and isinstance(bad.error, RecoveryFailed)
    eng.run(max_iters=300)
    assert {r.rid: r.status for r in eng.finished}[1] == "ok"


def test_deadline_expired_while_down_fails_at_rehydration(tmp_path,
                                                          fp32_caches):
    clock = FakeClock()
    store_dir = _crashed_store(tmp_path, clock=clock, deadline_ms=50.0)
    clock.advance_ms(200.0)
    eng = _port(tstore.CheckpointStore(str(store_dir)), clock=clock)
    assert eng.recovery["expired"] == 2 and eng.stats["iters"] == 0
    for r in eng.finished:
        assert r.status == "timed_out"
        assert isinstance(r.error, DeadlineExceeded)


def test_deadline_resumes_as_remaining_budget(tmp_path, fp32_caches):
    """150 ms deadline, 100 ms burned before the crash, 40 ms down: the
    request rehydrates (140 < 150) and 20 ms more expires it."""
    clock = FakeClock()
    root = str(tmp_path / "store")
    eng1 = _port(tstore.CheckpointStore(root), "kill@iter=4", clock=clock)
    _submit(eng1, Request, deadline_ms=150.0, rids=(1,))
    clock.advance_ms(100.0)
    with pytest.raises(SimulatedCrash):
        eng1.run(max_iters=300)
    clock.advance_ms(40.0)
    eng2 = _port(tstore.CheckpointStore(root), clock=clock)
    assert eng2.recovery["expired"] == 0 and sum(eng2.recovery.values()) == 1
    clock.advance_ms(20.0)
    eng2.run(max_iters=300)
    (req,) = eng2.finished
    assert req.status == "timed_out"
    assert isinstance(req.error, DeadlineExceeded)


def test_blob_meta_survives_the_file(tmp_path):
    tcache, _ = _filled("hybrid", "bfloat16")
    blob = offload_slot(tcache, 1, tags={"rid": 1, "priority": 2})
    back = tstore.parse_blob(tstore.dump_blob(blob))
    assert back[BLOB_META_KEY] == blob[BLOB_META_KEY]
    assert np.array_equal(back["pos"].numpy(), [17])

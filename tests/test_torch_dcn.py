"""The port's cross-slice exchanger (dear_pytorch_tpu_torch.comm.dcn)
against the JAX package's, on the CPU.

  - `_encode` / `_decode` are the JAX package's bit for bit: the same
    framed text for float32 with and without the integrity header, and
    each package decodes the other's;
  - the two packages interoperate on one `FileTransport` directory: JAX's
    exchanger plays slice 0 and the port's slice 1, in two threads, and
    both return the same means and loss mean, bitwise;
  - JAX's unit scenarios (tests/test_multislice.py:202-250, :744-1060) run
    on both packages' exchangers with the same inputs, and each outcome is
    held against the JAX run's: the means bitwise, the raised classes, the
    ``dcn.*`` counter values (where a counter counts polls of a deadline
    loop — chunk rejects, prefetch hits — both runs must reach the JAX
    test's bound), the include sets, the residuals;
  - `fit_dcn` and `price_degraded_round` equal JAX's.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from dear_pytorch_tpu.comm import dcn as jdcn
from dear_pytorch_tpu.observability import costmodel as jCM
from dear_pytorch_tpu.observability import overlap as jOV
from dear_pytorch_tpu_torch.comm import dcn as tdcn
from dear_pytorch_tpu_torch.observability import costmodel as tCM
from dear_pytorch_tpu_torch.observability import overlap as tOV


def _ns(pkg: str):
    """One package's exchanger and everything a scenario drives it with."""
    if pkg == "jax":
        from dear_pytorch_tpu.comm import dcn
        from dear_pytorch_tpu.observability import tracer
        from dear_pytorch_tpu.ops import fusion
        from dear_pytorch_tpu.resilience import cluster, inject
    else:
        from dear_pytorch_tpu_torch.comm import dcn
        from dear_pytorch_tpu_torch.observability import tracer
        from dear_pytorch_tpu_torch.ops import fusion
        from dear_pytorch_tpu_torch.resilience import cluster, inject
    return types.SimpleNamespace(pkg=pkg, dcn=dcn, T=tracer, F=fusion,
                                 CL=cluster, INJ=inject)


def _counting(ns):
    """Install a fresh counting tracer of ``ns``'s package; returns
    ``(tracer, restore)``."""
    prev = ns.T._tracer
    tracer = ns.T.Tracer([ns.T.MemoryExporter()])
    ns.T.set_tracer(tracer)
    return tracer, lambda: ns.T.set_tracer(prev)


def _dcn_counters(tracer) -> dict:
    return {k: v for k, v in tracer.counters().items()
            if k.startswith("dcn.")}


def _run_n(fns, join_s=60):
    out, err = [None] * len(fns), [None] * len(fns)

    def w(i, f):
        try:
            out[i] = f()
        except BaseException as exc:  # noqa: BLE001 - compared below
            err[i] = exc
    ts = [threading.Thread(target=w, args=(i, f))
          for i, f in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join_s)
    return out, err


def _cls(err):
    return None if err is None else type(err).__name__


# -- the wire framing ----------------------------------------------------------


@pytest.mark.parametrize("meta", [None, {"epoch": 2, "step": 7, "bucket": 1,
                                         "chunk": 3, "seq": 11}])
def test_encode_decode_bitwise(meta):
    rng = np.random.default_rng(0)
    for arr in (rng.normal(size=37).astype(np.float32),
                np.array([np.inf, -0.0, np.nan, 1e-42], np.float32),
                np.zeros(0, np.float32)):
        text = tdcn._encode(arr, meta=meta)
        assert text == jdcn._encode(arr, meta=meta)
        expect = None if meta is None else {
            k: meta[k] for k in ("epoch", "step", "bucket", "chunk")}
        for dec in (tdcn._decode, jdcn._decode):
            back = dec(text, expect=expect)
            assert back.dtype == np.float32
            assert back.tobytes() == arr.tobytes()
    # a torn payload is rejected by both
    head, _, body = jdcn._encode(np.ones(6, np.float32), meta={
        "epoch": 0, "step": 0, "bucket": 0, "chunk": 0, "seq": 1}).partition(
            "\n")
    with pytest.raises(tdcn._ChunkReject):
        tdcn._decode(head + "\n" + body[:8], expect={
            "epoch": 0, "step": 0, "bucket": 0, "chunk": 0})


def test_state_arrays_roundtrip_across_packages():
    a = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    d = tdcn._encode_state_array(a)
    assert d == jdcn._encode_state_array(a)
    np.testing.assert_array_equal(jdcn._decode_state_array(d), a)
    np.testing.assert_array_equal(tdcn._decode_state_array(d), a)


# -- one shared FileTransport directory, both packages ---------------------------


@pytest.mark.parametrize("partition_mb", [0.00002, None])
def test_packages_interoperate_on_one_directory(tmp_path, partition_mb):
    """JAX's exchanger is slice 0 and the port's slice 1 over one
    FileTransport directory; three rounds, both sides bitwise equal."""
    from dear_pytorch_tpu.resilience.cluster import FileTransport as jFT
    from dear_pytorch_tpu_torch.resilience.cluster import FileTransport as tFT

    root = str(tmp_path / "dcn")
    ex0 = jdcn.DcnExchanger(jFT(root), local_slices=(0,), slices=(0, 1),
                            partition_mb=partition_mb, timeout_s=10.0)
    ex1 = tdcn.DcnExchanger(tFT(root), local_slices=(1,), slices=(0, 1),
                            partition_mb=partition_mb, timeout_s=10.0)
    rng = np.random.default_rng(2)
    for step in range(3):
        b0 = [rng.normal(size=n).astype(np.float32) for n in (24, 8)]
        b1 = [rng.normal(size=n).astype(np.float32) for n in (24, 8)]
        out, err = _run_n([lambda: ex0.exchange(step, {0: b0}, {0: 1.25}),
                           lambda: ex1.exchange(step, {1: b1}, {1: 0.5})])
        assert not any(err), err
        (m0, s0), (m1, s1) = out
        for g in range(2):
            assert m0[g].tobytes() == m1[g].tobytes()
            np.testing.assert_array_equal(m0[g], (b0[g] + b1[g]) / 2.0)
        assert s0 == s1 == 0.875
    assert ex0.samples() and ex1.samples()


# -- JAX's unit scenarios, on both packages ------------------------------------


def sc_renorm_and_timeout(ns, tmp):
    """test_multislice.py::test_dcn_renorm_and_timeout"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.FileTransport(str(tmp / ns.pkg))
        ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                                  timeout_s=0.3)
        ex0.set_slices((0,), epoch=1)
        buf = [np.ones(8, np.float32) * 3.0]
        means, sm = ex0.exchange(0, {0: buf}, {0: 2.0})
        ex0.set_slices((0, 1), epoch=2)
        t0 = time.monotonic()
        try:
            ex0.exchange(1, {0: buf}, {0: 2.0})
            timeout = None
        except Exception as exc:  # noqa: BLE001
            timeout = _cls(exc)
        quick = time.monotonic() - t0 < 5.0
        try:
            ex0.set_slices((1,), epoch=3)
            drop_local = None
        except ValueError as exc:
            drop_local = "local slice" in str(exc)
        return {"means": [m.tobytes() for m in means], "sm": sm,
                "timeout": timeout, "quick": quick,
                "drop_local": drop_local, "epoch": ex0.epoch,
                "counters": _dcn_counters(tracer)}
    finally:
        restore()


def sc_drop_and_slow(ns, tmp):
    """test_multislice.py::test_dcn_drop_and_slow_faults"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.LocalTransport()
        inj = ns.INJ.FaultInjector(
            ns.INJ.parse_faults("dcn_drop@1:s0,dcn_slow@2:0.05:s0"),
            own_rank=0, own_slice=0)
        ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                                  timeout_s=0.4, injector=inj)
        ex1 = ns.dcn.DcnExchanger(tr, local_slices=(1,), slices=(0, 1),
                                  timeout_s=0.4)
        b = [np.ones(4, np.float32)]
        _, err1 = _run_n([lambda: ex0.exchange(0, {0: b}),
                          lambda: ex1.exchange(0, {1: b})])
        t0 = time.monotonic()
        out, err2 = _run_n([lambda: ex0.exchange(0, {0: b}),
                            lambda: ex1.exchange(0, {1: b})])
        slow = time.monotonic() - t0 >= 0.05
        return {"round1": [_cls(e) for e in err1][1],
                "round1_slice0": _cls(err1[0]) in (None, "DcnPeerTimeout"),
                "round2": [_cls(e) for e in err2], "slow": slow,
                "means": [o[0][0].tobytes() for o in out],
                "slow_s": inj.dcn_slow_s,
                "counters": _dcn_counters(tracer)}
    finally:
        restore()


def sc_chunk_integrity(ns, tmp):
    """test_multislice.py::test_dcn_chunk_integrity_rejects"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.FileTransport(str(tmp / ns.pkg))
        ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                                  partition_mb=None, timeout_s=0.4)
        b0 = [np.arange(6, dtype=np.float32)]
        b1 = [np.ones(6, np.float32)]
        raised = []
        tr.set(ex0._key(3, 0, 0, 1), ns.dcn._encode(
            b1[0], meta={"epoch": 0, "step": 0, "bucket": 0, "chunk": 0,
                         "seq": 1}))
        try:
            ex0.exchange(3, {0: b0})
        except Exception as exc:  # noqa: BLE001
            raised.append(_cls(exc))
        good = ns.dcn._encode(b1[0], meta={"epoch": 0, "step": 4,
                                           "bucket": 0, "chunk": 0,
                                           "seq": 2})
        head, _, body = good.partition("\n")
        tr.set(ex0._key(4, 0, 0, 1), head + "\n" + body[:8])
        try:
            ex0.exchange(4, {0: b0})
        except Exception as exc:  # noqa: BLE001
            raised.append(_cls(exc))
        tr.set(ex0._key(5, 0, 0, 1), ns.dcn._encode(
            b1[0], meta={"epoch": 0, "step": 5, "bucket": 0, "chunk": 0,
                         "seq": 3}))
        means, _ = ex0.exchange(5, {0: b0})
        c = _dcn_counters(tracer)
        rejects = c.pop("dcn.chunk_rejects", 0)
        return {"raised": raised, "means": means[0].tobytes(),
                "rejects_ge_2": rejects >= 2, "counters": c}
    finally:
        restore()


def sc_skip_replica_identical(ns, tmp):
    """test_multislice.py::test_dcn_degraded_skip_is_replica_identical"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.LocalTransport()
        inj2 = ns.INJ.FaultInjector(ns.INJ.parse_faults("dcn_drop@1:s2"),
                                    own_rank=0, own_slice=2)
        exs = [ns.dcn.DcnExchanger(
            tr, local_slices=(i,), slices=(0, 1, 2), partition_mb=0.00002,
            timeout_s=1.5, retries=1, staleness=2,
            injector=inj2 if i == 2 else None) for i in range(3)]
        rng = np.random.default_rng(7)
        g1 = [rng.normal(size=9).astype(np.float32) for _ in range(3)]
        g2 = [rng.normal(size=9).astype(np.float32) for _ in range(3)]
        out, err = _run_n([(lambda i=i: exs[i].exchange(0, {i: [g1[i]]}))
                           for i in range(3)])
        assert not any(err), err
        residual = [r.tobytes() for r in exs[2]._residual[2]]
        out2, err = _run_n([(lambda i=i: exs[i].exchange(1, {i: [g2[i]]}))
                            for i in range(3)])
        assert not any(err), err
        return {"round1": [o[0][0].tobytes() for o in out],
                "round2": [o[0][0].tobytes() for o in out2],
                "residual": residual,
                "staleness": [dict(e._staleness) for e in exs],
                "counters": _dcn_counters(tracer)}
    finally:
        restore()


def sc_residual_roundtrip_and_repack(ns, tmp):
    """test_multislice.py::test_dcn_residual_state_roundtrip_and_repack"""
    tr = ns.CL.LocalTransport()
    ex = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                             staleness=2)
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "c": rng.normal(size=(3, 3)).astype(np.float32)}
    if ns.pkg == "port":
        import torch

        leaves_in = {k: torch.from_numpy(v) for k, v in params.items()}
        old_plan = ns.F.plan_by_threshold(leaves_in, 1, threshold_mb=1e-4)
        new_plan = ns.F.plan_by_threshold(leaves_in, 1, threshold_mb=1.0)
        leaves = [leaves_in[s.name] for s in old_plan.leaves]
        rows = [ns.F.pack_bucket(leaves, old_plan, b).numpy()
                for b in range(old_plan.num_buckets)]

        def unpack(row, plan, b):
            return {lid: v.numpy() for lid, v in ns.F.unpack_bucket(
                torch.from_numpy(row), plan, b).items()}
    else:
        import jax

        old_plan = ns.F.plan_by_threshold(params, 1, threshold_mb=1e-4)
        new_plan = ns.F.plan_by_threshold(params, 1, threshold_mb=1.0)
        leaves = jax.tree_util.tree_leaves(params)
        rows = [np.asarray(ns.F.pack_bucket(leaves, old_plan, b), np.float32)
                for b in range(old_plan.num_buckets)]

        def unpack(row, plan, b):
            return {lid: np.asarray(v) for lid, v in ns.F.unpack_bucket(
                row, plan, b).items()}
    ex._residual = {0: rows}
    ex._staleness = {0: 1, 1: 0}
    blob = json.loads(json.dumps(ex.state_dict()))
    ex2 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                              staleness=2)
    ex2.load_state_dict(blob)
    ex.repack_residual(old_plan, new_plan)
    rec = {}
    for b in range(new_plan.num_buckets):
        rec.update(unpack(ex._residual[0][b], new_plan, b))
    names = [s.name if hasattr(s, "name") else i
             for i, s in enumerate(new_plan.leaves)]
    per_leaf = {str(n): rec[i].tobytes() for i, n in enumerate(names)}
    ex3 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1),
                              staleness=2)
    ex3.load_state_dict({"residual": {"0": [{"bogus": True}]}})
    return {"blob": blob,
            "reloaded": [r.tobytes() for r in ex2._residual[0]],
            "staleness": dict(ex2._staleness),
            "buckets": (old_plan.num_buckets, new_plan.num_buckets),
            "repacked": [r.tobytes() for r in ex._residual[0]],
            "leaf_values": sorted(per_leaf.values()),
            "alien_reset": ex3._residual == {}}


def sc_flap_partition_schedule(ns, tmp):
    """test_multislice.py::test_dcn_flap_partition_grammar_and_schedule"""
    fs = ns.INJ.parse_faults("dcn_flap@3:2:s1,dcn_partition@5:0.25:s0")
    inj = ns.INJ.FaultInjector([ns.INJ.Fault(kind="dcn_flap", step=3,
                                             arg=2)],
                               own_rank=0, own_slice=0)
    sched = [inj.dcn_outage_due(n) for n in range(1, 9)]
    inj2 = ns.INJ.FaultInjector([ns.INJ.Fault(kind="dcn_partition", step=2,
                                              arg=0.2)],
                                own_rank=0, own_slice=0)
    part = [inj2.dcn_outage_due(1)]
    t0 = time.monotonic()
    part += [inj2.dcn_outage_due(2), inj2.dcn_outage_due(3)]
    time.sleep(max(0.0, 0.25 - (time.monotonic() - t0)))
    part.append(inj2.dcn_outage_due(4))
    inj3 = ns.INJ.FaultInjector(ns.INJ.parse_faults("dcn_flap@1:2:s1"),
                                own_rank=0, own_slice=0)
    return {"faults": [(f.kind, f.slice_id, f.arg) for f in fs],
            "sched": sched, "partition": part,
            "off_target": (inj3.dcn_outage_due(1), bool(inj3.skipped),
                           bool(inj3.fired))}


def sc_sustained_partition(ns, tmp):
    """test_multislice.py::test_dcn_sustained_partition_walks_the_ladder"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.LocalTransport()
        inj1 = ns.INJ.FaultInjector(
            ns.INJ.parse_faults("dcn_partition@1:30:s1"),
            own_rank=0, own_slice=1)
        kw = dict(partition_mb=None, timeout_s=0.8, retries=1, staleness=1)
        ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1), **kw)
        ex1 = ns.dcn.DcnExchanger(tr, local_slices=(1,), slices=(0, 1),
                                  injector=inj1, **kw)
        b = [np.ones(4, np.float32)]
        evicted_at, evicted, survivor = None, None, []
        for step in range(4):
            out, err = _run_n([lambda s=step: ex0.exchange(s, {0: b}),
                               lambda s=step: ex1.exchange(s, {1: b})])
            assert err[0] is None, err[0]
            survivor.append(out[0][0][0].tobytes())
            if err[1] is not None:
                evicted_at, evicted = step, _cls(err[1])
                break
        t0 = time.monotonic()
        means, _ = ex0.exchange(9, {0: b})
        alone_quick = time.monotonic() - t0 < ex0.timeout_s
        c = _dcn_counters(tracer)
        return {"evicted": evicted, "evicted_at": evicted_at,
                "survivor": survivor, "alone": means[0].tobytes(),
                "alone_quick": alone_quick,
                "escalated": sorted(ex0._escalated),
                "ladder": (c.get("dcn.escalations", 0) >= 1,
                           c.get("dcn.self_evicts", 0) >= 1,
                           c.get("dcn.skips", 0) >= 2)}
    finally:
        restore()


def sc_prefetch(ns, tmp):
    """test_multislice.py::test_dcn_prefetch_overlaps_next_round"""
    tracer, restore = _counting(ns)
    try:
        tr = ns.CL.LocalTransport()
        kw = dict(partition_mb=0.00002, timeout_s=2.0, staleness=1)
        ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1), **kw)
        ex1 = ns.dcn.DcnExchanger(tr, local_slices=(1,), slices=(0, 1), **kw)
        b0 = [np.arange(9, dtype=np.float32)]
        b1 = [np.ones(9, np.float32) * 2.0]
        out, err = _run_n([lambda: ex0.exchange(0, {0: b0}),
                           lambda: ex1.exchange(0, {1: b1})])
        assert not any(err), err
        t1 = threading.Thread(target=lambda: ex1.exchange(1, {1: b1}))
        t1.start()
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            try:
                tr.get(ex0._key(1, 0, 0, 1), 0.05)
                break
            except ns.CL.PeerTimeout:
                pass
        ex0.prefetch(1)
        ex0._join_prefetch()
        means, _ = ex0.exchange(1, {0: b0})
        t1.join(10)
        return {"round0": out[0][0][0].tobytes(),
                "means": means[0].tobytes(),
                "hits": tracer.counters().get("dcn.prefetch_hits", 0) >= 1}
    finally:
        restore()


def sc_bounded_stale_band(ns, tmp):
    """test_multislice.py::test_dcn_bounded_stale_loss_parity_band"""
    tr = ns.CL.LocalTransport()
    inj1 = ns.INJ.FaultInjector(ns.INJ.parse_faults("dcn_flap@3:2:s1"),
                                own_rank=0, own_slice=1)
    kw = dict(partition_mb=None, timeout_s=1.0, retries=1, staleness=2)
    ex0 = ns.dcn.DcnExchanger(tr, local_slices=(0,), slices=(0, 1), **kw)
    ex1 = ns.dcn.DcnExchanger(tr, local_slices=(1,), slices=(0, 1),
                              injector=inj1, **kw)
    rng = np.random.default_rng(11)
    c0 = rng.normal(size=8).astype(np.float32)
    c1 = -c0 + rng.normal(size=8).astype(np.float32) * 0.3
    w0 = rng.normal(size=8).astype(np.float32) * 3.0
    lr = 0.2
    w = [w0.copy(), w0.copy()]
    for s in range(12):
        out, err = _run_n([lambda s=s: ex0.exchange(s, {0: [w[0] - c0]}),
                           lambda s=s: ex1.exchange(s, {1: [w[1] - c1]})])
        assert not any(err), err
        assert out[0][0][0].tobytes() == out[1][0][0].tobytes()
        w = [wi - lr * out[i][0][0] for i, wi in enumerate(w)]
    opt = (c0 + c1) / 2.0
    d0 = float(np.linalg.norm(w0 - opt))
    return {"w": w[0].tobytes(), "replicas_equal": bool(
        np.array_equal(w[0], w[1])),
        "converges": float(np.linalg.norm(w[0] - opt)) < 0.35 * d0,
        "fired": [f.kind for f in inj1.fired]}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_renorm_and_timeout, sc_drop_and_slow, sc_chunk_integrity,
    sc_skip_replica_identical, sc_residual_roundtrip_and_repack,
    sc_flap_partition_schedule, sc_sustained_partition, sc_prefetch,
    sc_bounded_stale_band)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    """One JAX unit scenario on JAX's exchanger, then on the port's: the
    two records are equal."""
    f = SCENARIOS[name]
    jax_rec = f(_ns("jax"), tmp_path)
    port_rec = f(_ns("port"), tmp_path)
    assert port_rec == jax_rec


def test_scenario_records_hold_jax_assertions(tmp_path):
    """The records carry what JAX's tests assert (so equal records are not
    equally wrong): spot-check the port's on the cheapest scenarios."""
    ns = _ns("port")
    r = sc_renorm_and_timeout(ns, tmp_path)
    assert r["timeout"] == "DcnPeerTimeout" and r["quick"]
    assert r["drop_local"] and r["sm"] == 2.0
    assert r["counters"]["dcn.renorms"] == 2
    r = sc_chunk_integrity(ns, tmp_path)
    assert r["raised"] == ["DcnChunkReject", "DcnChunkReject"]
    assert r["rejects_ge_2"]
    r = sc_flap_partition_schedule(ns, tmp_path)
    assert r["sched"] == [False, False, True, False, True, False, False,
                          False]
    assert r["partition"] == [False, True, True, False]
    assert r["off_target"] == (False, True, False)


# -- the α-β fit and the degraded-round price ----------------------------------


def test_fit_dcn_and_degraded_price_match_jax():
    samples = [(1024.0 * k, 1e-4 + 2e-9 * 1024.0 * k + 1e-6 * (k % 3))
               for k in range(1, 12)]
    assert tCM.fit_dcn(samples) == jCM.fit_dcn(samples)
    assert tOV.fit_dcn(samples) == jOV.fit_dcn(samples)
    with pytest.raises(ValueError, match="DCN fit needs"):
        tCM.fit_dcn(samples[:2])
    tfit, jfit = tCM.LinkFit(1e-4, 2e-9), jCM.LinkFit(1e-4, 2e-9)
    for kw in (dict(wire_bytes=3e6, timeout_s=2.0),
               dict(wire_bytes=3e6, timeout_s=2.0, partition_mb=0.5),
               dict(wire_bytes=0.0, timeout_s=2.0, partition_mb=0.5),
               dict(wire_bytes=3e6, timeout_s=2.0, outage=True)):
        wb = kw.pop("wire_bytes")
        assert (tCM.price_degraded_round(tfit, wb, **kw)
                == jCM.price_degraded_round(jfit, wb, **kw))


def _lockstep_rounds(mod, CL, timeout_s, rounds=3):
    """Two slices in lockstep, each arming the cross-iteration prefetch
    right before its exchange (where the train step arms it): the slowest
    round's seconds."""
    tr = CL.LocalTransport()
    exs = [mod.DcnExchanger(tr, local_slices=(i,), slices=(0, 1),
                            partition_mb=0.00002, timeout_s=timeout_s,
                            retries=1, staleness=2) for i in range(2)]
    b = [np.ones(64, np.float32)]
    worst = [0.0, 0.0]

    def run(i):
        for s in range(rounds):
            exs[i].prefetch(s)
            t0 = time.monotonic()
            exs[i].exchange(s, {i: b})
            worst[i] = max(worst[i], time.monotonic() - t0)

    _, err = _run_n([lambda: run(0), lambda: run(1)])
    assert not any(err), err
    return max(worst)


def test_lockstep_prefetch_does_not_wait_out_the_budget():
    """The port's one repair of the exchanger: JAX's joins the prefetch
    thread before publishing, so each of two slices in lockstep waits for
    the other's publish until its fetch budget runs out, every round; the
    port joins it after its own publish, and a round takes milliseconds."""
    assert _lockstep_rounds(jdcn, __import__(
        "dear_pytorch_tpu.resilience.cluster", fromlist=["x"]), 0.5) >= 0.45
    assert _lockstep_rounds(tdcn, __import__(
        "dear_pytorch_tpu_torch.resilience.cluster", fromlist=["x"]),
        3.0) < 1.0

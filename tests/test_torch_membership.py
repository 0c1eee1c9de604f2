"""Elastic membership, the scale policy and the object store of the port
(`dear_pytorch_tpu_torch.resilience.{membership,scale}`,
`utils.objectstore`) held equal to the JAX package's.

The membership is pure protocol: each scenario of the JAX package's
``tests/test_elastic.py`` (:78-643) and the slice-granular ones of
``tests/test_multislice.py`` (:298-459) drives N `ElasticCluster`
instances on N threads over one `LocalTransport` (or a `FileTransport`
under ``tmp_path``), once with the JAX package's modules and once with
the port's, and returns what came out — views, verdicts, epochs, the
durable decision records, the exceptions' types. The two records must be
equal. The scale policy runs on a fake clock; the object store on a
directory.
"""

import json
import os
import threading
import time

import pytest

from dear_pytorch_tpu.resilience import cluster as JCL
from dear_pytorch_tpu.resilience import membership as JM
from dear_pytorch_tpu.resilience import scale as JSC
from dear_pytorch_tpu.utils import objectstore as JOS
from dear_pytorch_tpu_torch.resilience import cluster as TCL
from dear_pytorch_tpu_torch.resilience import membership as TM
from dear_pytorch_tpu_torch.resilience import scale as TSC
from dear_pytorch_tpu_torch.utils import objectstore as TOS

IMPLS = {"jax": (JM, JCL), "torch": (TM, TCL)}
_T = 0.5   # the exchange deadline of the scenarios (seconds)


def _threads(fns, join_s=60):
    res, errs = [None] * len(fns), [None] * len(fns)

    def work(i):
        try:
            res[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 - recorded
            errs[i] = exc

    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join_s)
    return res, errs


def _norm(x):
    """A JSON-comparable image of a scenario's outputs."""
    if isinstance(x, BaseException):
        return {"raised": type(x).__name__,
                "missing": list(getattr(x, "missing_ranks", ()))}
    if hasattr(x, "_fields"):   # views and verdicts
        out = {f: _norm(getattr(x, f)) for f in x._fields}
        for prop in ("membership_changed", "self_draining", "data_shard",
                     "data_world"):
            if hasattr(type(x), prop):
                out[prop] = getattr(x, prop)
        return out
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _norm(v) for k, v in x.items()}
    return x


class _Fleet:
    """N members of one implementation over one transport."""

    def __init__(self, impl, transport, n, *, rps=None, timeout_s=_T,
                 ranks=None):
        self.M, self.CL = IMPLS[impl]
        self.t = transport
        ranks = list(range(n) if ranks is None else ranks)
        self.ms = [self.M.ElasticCluster(
            rank=r, members=ranks, transport=transport, timeout_s=timeout_s,
            ranks_per_slice=rps) for r in ranks]
        self.ns = self.ms[0]._ns

    def record(self, key):
        try:
            return json.loads(self.t.get(f"{self.ns}/{key}", 0.05))
        except self.CL.PeerTimeout:
            return None

    def state(self):
        return [(c.epoch, list(c.members)) for c in self.ms]


def _transport(impl, kind, tmp_path, n):
    CL = IMPLS[impl][1]
    if kind == "file":
        return CL.FileTransport(str(tmp_path / impl))
    return CL.LocalTransport(n)


def _member_loop(c, v_want, *, start=1, steps=60):
    for step in range(start, start + steps):
        v = c.health_check(True, step=step)
        if v_want(v):
            return v
        time.sleep(0.03)
    raise AssertionError("the membership never moved")


# -- the scenarios (JAX test names in each docstring) -------------------------


def sc_exchange_member_ordered(f):
    """test_exchange_is_member_ordered"""
    return _threads([(lambda c=c, i=i: c.exchange("hello", f"msg{i}"))
                     for i, c in enumerate(f.ms)])


def sc_missing_member(f):
    """test_missing_member_attaches_missing_ranks"""
    return _threads([(lambda c=f.ms[0]: c.exchange("t", "a")),
                     (lambda c=f.ms[1]: c.exchange("t", "b"))])


def sc_health_check_reconfig(f):
    """test_health_check_converts_loss_into_reconfig"""
    out = _threads([(lambda c=f.ms[0]: c.health_check(True, fingerprint="f",
                                                      step=7)),
                    (lambda c=f.ms[1]: c.health_check(True, fingerprint="f",
                                                      step=7))])
    post = _threads([(lambda c=f.ms[0]: c.exchange("post", "p0")),
                     (lambda c=f.ms[1]: c.exchange("post", "p1"))])
    return out, post, f.state()[:2], f.record("decided/e1")


def sc_concurrent_failure_widens(f):
    """test_concurrent_failure_during_reconfig_widens"""
    f.t.set(f"{f.ns}/e0/health/0/2", json.dumps(
        {"ok": True, "fp": "", "pre": False, "rejoin": {}}))
    out = _threads([(lambda c=f.ms[0]: c.health_check(True, step=1)),
                    (lambda c=f.ms[1]: c.health_check(True, step=1))])
    return out, f.state()[:2], f.record("decided/e1")


def sc_reconfigure_rejects(f):
    """test_reconfigure_rejects_self_and_non_members"""
    c = f.ms[0]
    out = []
    for dead in ([0], [9]):
        try:
            c.reconfigure(dead)
        except Exception as exc:   # noqa: BLE001 - recorded
            out.append(exc)
    return out


def sc_evicted_when_declared_dead(f):
    """test_evicted_when_peers_declared_me_dead"""
    out = _threads([(lambda c=f.ms[0]: c.reconfigure([2])),
                    (lambda c=f.ms[1]: c.reconfigure([0]))])
    return out, f.state(), f.record("decided/e1")


def sc_sole_survivor(f):
    """test_sole_survivor_commits_unilaterally"""
    return f.ms[0].reconfigure([1]), f.record("decided/e1")


def sc_falsely_evicted_cannot_fork(f):
    """test_falsely_evicted_rank_cannot_fork_the_membership"""
    out = _threads([(lambda c=f.ms[1]: c.reconfigure([0])),
                    (lambda c=f.ms[2]: c.reconfigure([0]))])
    late = _threads([lambda: f.ms[0].reconfigure([1, 2])])
    return out, late, f.state(), f.record("decided/e1")


def sc_missed_commit_ack(f):
    """test_missed_commit_ack_defers_to_decided_record"""
    f.t.decide_once(f"{f.ns}/decided/e1", json.dumps([0, 1, 2]))
    return _threads([lambda: f.ms[0].reconfigure([1, 2])]), f.state()


def sc_rejoin_after_shrink(f):
    """test_rejoin_after_shrink_admits_at_epoch_barrier and
    test_admission_writes_the_epoch_decision_record"""
    shrink = _threads([(lambda c=f.ms[0]: c.health_check(True, step=3)),
                       (lambda c=f.ms[1]: c.health_check(True, step=3))])
    back = f.M.ElasticCluster(rank=2, members=[0, 1, 2], transport=f.t,
                              timeout_s=1.0)
    for c in f.ms[:2]:
        c.timeout_s = 1.0

    def rejoiner():
        view, ctx = back.rejoin(0, timeout_s=20)
        return view, ctx["steps_seen"] >= 4, back.exchange("post", "p2")

    def member(c):
        v = _member_loop(c, lambda v: v.admitted, start=4)
        return v, c.exchange("post", f"p{c.rank}")

    out = _threads([(lambda c=f.ms[0]: member(c)),
                    (lambda c=f.ms[1]: member(c)), rejoiner])
    return (shrink, out, f.state()[:2], f.record("decided/e1"),
            f.record("decided/e2"))


def sc_rejoin_racing_shrink(f):
    """test_rejoin_racing_a_shrink_is_reconfigured_back_out"""
    f.t.set(f"{f.ns}/rejoin/req/7", json.dumps(
        {"rank": 7, "last_epoch": 0, "nonce": "dead07"}))
    for c in f.ms:
        c.initial_ranks = (0, 1, 7)
    first = _threads([(lambda c=f.ms[0]: c.health_check(True, step=1)),
                      (lambda c=f.ms[1]: c.health_check(True, step=1))])
    second = _threads([(lambda c=f.ms[0]: c.health_check(True, step=2)),
                       (lambda c=f.ms[1]: c.health_check(True, step=2))])
    return first, second, f.state(), f.record("decided/e1"), \
        f.record("decided/e2")


def sc_scale_up_brand_new(f):
    """test_scale_up_admits_a_brand_new_rank"""
    for c in f.ms:
        c.timeout_s = 1.0
    fresh = f.M.ElasticCluster(rank=5, members=[0, 1], transport=f.t,
                               timeout_s=1.0, joining=True)

    def joiner():
        view, _ = fresh.rejoin(None, timeout_s=20)
        return view, fresh.exchange("post", "p5")

    def member(c):
        v = _member_loop(c, lambda v: v.admitted)
        return v, c.exchange("post", f"p{c.rank}")

    out = _threads([(lambda c=f.ms[0]: member(c)),
                    (lambda c=f.ms[1]: member(c)), joiner])
    return (out, f.state(), [list(c.initial_ranks) for c in f.ms],
            f.record("decided/e1"))


def sc_scale_up_racing_shrink(f):
    """test_scale_up_racing_a_shrink"""
    fresh = f.M.ElasticCluster(rank=7, members=[0, 1, 2], transport=f.t,
                               timeout_s=_T, joining=True)
    out = _threads([
        (lambda c=f.ms[0]: _member_loop(c, lambda v: v.admitted)),
        (lambda c=f.ms[1]: _member_loop(c, lambda v: v.admitted)),
        lambda: fresh.rejoin(None, timeout_s=30)[0]])
    return out, f.state()[:2], f.record("decided/e1"), \
        f.record("decided/e2")


def sc_drain_planned_shrink(f):
    """test_drain_commits_planned_shrink_without_timeout"""
    for c in f.ms:
        c.timeout_s = 5.0
    t0 = time.monotonic()
    out = _threads([
        (lambda c=f.ms[0]: c.health_check(True, step=1)),
        (lambda c=f.ms[1]: c.health_check(True, step=1)),
        (lambda c=f.ms[2]: c.health_check(True, step=1, draining=True))])
    fast = time.monotonic() - t0 < 4.0
    post = _threads([(lambda c=f.ms[0]: c.exchange("post", "a")),
                     (lambda c=f.ms[1]: c.exchange("post", "b"))])
    return out, fast, post, f.state(), f.record("decided/e1")


def sc_consensus_restore_member_scoped(f):
    """test_consensus_restore_is_member_scoped"""
    for c in f.ms:
        c.timeout_s = 1.0
    _threads([(lambda c=f.ms[0]: c.health_check(True, step=1)),
              (lambda c=f.ms[1]: c.health_check(True, step=1))])
    views = {0: [12, 8, 4], 1: [8, 4]}
    return _threads([
        (lambda c=f.ms[0]: c.consensus_restore_step(views[0])),
        (lambda c=f.ms[1]: c.consensus_restore_step(views[1]))]), f.state()


def sc_consensus_restore_second_failure(f):
    """test_consensus_restore_survives_second_failure"""
    os.environ[f.CL.RESTORE_TIMEOUT_ENV] = str(_T)
    try:
        out = _threads([
            (lambda c=f.ms[0]: c.consensus_restore_step([8, 4])),
            (lambda c=f.ms[1]: c.consensus_restore_step([8]))])
    finally:
        os.environ.pop(f.CL.RESTORE_TIMEOUT_ENV, None)
    return out, f.state()[:2]


def sc_slice_whole_loss(f):
    """test_multislice.py::test_whole_slice_loss_commits_one_epoch"""
    out = _threads([(lambda c=f.ms[0]: c.health_check(True, step=3)),
                    (lambda c=f.ms[1]: c.health_check(True, step=3))])
    return out, list(f.ms[0].slices), f.record("decided/e1"), \
        f.record("decided/e2")


def sc_slice_partial_loss(f):
    """test_multislice.py::test_partial_slice_loss_widens_to_the_slice"""
    return _threads([(lambda c=f.ms[0]: c.health_check(True, step=3)),
                     (lambda c=f.ms[1]: c.health_check(True, step=3)),
                     (lambda c=f.ms[2]: c.health_check(True, step=3))]), \
        f.record("decided/e1")


def sc_slice_gated_admission(f):
    """test_multislice.py::test_slice_gated_admission_defers_partial_slice"""
    for c in f.ms:
        c.timeout_s = 1.0
    _threads([(lambda c=f.ms[0]: c.health_check(True, step=1)),
              (lambda c=f.ms[1]: c.health_check(True, step=1))])
    f.t.set(f"{f.ns}/rejoin/req/2",
            json.dumps({"rank": 2, "last_epoch": 0, "nonce": "aa"}))
    deferred = _threads([(lambda c=f.ms[0]: c.health_check(True, step=2)),
                         (lambda c=f.ms[1]: c.health_check(True, step=2))])
    pending = f.t.get(f"{f.ns}/rejoin/req/2", 0.05)
    f.t.set(f"{f.ns}/rejoin/req/3",
            json.dumps({"rank": 3, "last_epoch": 0, "nonce": "bb"}))
    back = [f.M.ElasticCluster(rank=r, members=range(4), transport=f.t,
                               timeout_s=1.0, ranks_per_slice=2)
            for r in (2, 3)]

    def rejoin(c, nonce):
        ack = json.loads(f.t.get(f"{c._ns}/rejoin/ack/{c.rank}/{nonce}",
                                 10.0))
        c._commit(int(ack["epoch"]), ack["members"])
        c.exchange("admit.barrier", "{}")
        return c.view()

    out = _threads([(lambda c=f.ms[0]: c.health_check(True, step=3)),
                    (lambda c=f.ms[1]: c.health_check(True, step=3)),
                    (lambda: rejoin(back[0], "aa")),
                    (lambda: rejoin(back[1], "bb"))])
    return deferred, pending, out, f.record("decided/e2")


def sc_slice_drain_closure(f):
    """test_multislice.py::test_slice_drain_closure"""
    for c in f.ms:
        c.timeout_s = 1.0
    return _threads([
        (lambda c=f.ms[0]: c.health_check(True, step=5)),
        (lambda c=f.ms[1]: c.health_check(True, step=5)),
        (lambda c=f.ms[2]: c.health_check(True, step=5)),
        (lambda c=f.ms[3]: c.health_check(True, step=5, draining=True))]), \
        f.record("decided/e1")


def sc_slice_views(f):
    """test_multislice.py::test_view_slice_data_shard"""
    return [c.view() for c in f.ms]


#: scenario -> (members, ranks per slice or None, transports)
SCENARIOS = {
    "exchange_member_ordered": (sc_exchange_member_ordered, 3, None),
    "missing_member": (sc_missing_member, 3, None),
    "health_check_reconfig": (sc_health_check_reconfig, 3, None),
    "concurrent_failure_widens": (sc_concurrent_failure_widens, 4, None),
    "reconfigure_rejects": (sc_reconfigure_rejects, 1, None),
    "evicted_when_declared_dead": (sc_evicted_when_declared_dead, 3, None),
    "sole_survivor": (sc_sole_survivor, 2, None),
    "falsely_evicted_cannot_fork": (sc_falsely_evicted_cannot_fork, 3,
                                    None),
    "missed_commit_ack": (sc_missed_commit_ack, 3, None),
    "rejoin_after_shrink": (sc_rejoin_after_shrink, 3, None),
    "rejoin_racing_shrink": (sc_rejoin_racing_shrink, 2, None),
    "scale_up_brand_new": (sc_scale_up_brand_new, 2, None),
    "scale_up_racing_shrink": (sc_scale_up_racing_shrink, 3, None),
    "drain_planned_shrink": (sc_drain_planned_shrink, 3, None),
    "consensus_restore_member_scoped": (sc_consensus_restore_member_scoped,
                                        3, None),
    "consensus_restore_second_failure": (
        sc_consensus_restore_second_failure, 3, None),
    "slice_whole_loss": (sc_slice_whole_loss, 4, 2),
    "slice_partial_loss": (sc_slice_partial_loss, 4, 2),
    "slice_gated_admission": (sc_slice_gated_admission, 4, 2),
    "slice_drain_closure": (sc_slice_drain_closure, 4, 2),
    "slice_views": (sc_slice_views, 4, 2),
}
#: the scenarios whose store must outlive a member run on both transports
_FILE_TOO = {"health_check_reconfig", "rejoin_after_shrink",
             "scale_up_brand_new", "drain_planned_shrink",
             "slice_gated_admission", "missed_commit_ack"}
CASES = ([(name, "local") for name in SCENARIOS]
         + [(name, "file") for name in sorted(_FILE_TOO)])


@pytest.mark.parametrize("name,kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_membership_scenario_matches_jax(name, kind, tmp_path):
    fn, n, rps = SCENARIOS[name]
    records = {}
    for impl in IMPLS:
        f = _Fleet(impl, _transport(impl, kind, tmp_path, n), n, rps=rps)
        records[impl] = _norm(fn(f))
    assert records["torch"] == records["jax"]
    assert records["jax"] not in (None, [], {})


def test_membership_env_contract_and_epoch_match_jax(tmp_path, monkeypatch):
    """``from_env`` (the supervisor's contract, with the launcher's
    ``DEAR_*`` names as the port's fallback), ``rejoining_by_env``,
    ``current_epoch`` and a file transport given as a string."""
    out = {}
    for impl, (M, CL) in IMPLS.items():
        monkeypatch.setenv(M.ELASTIC_DIR_ENV, str(tmp_path / impl))
        monkeypatch.setenv(M.ELASTIC_RANK_ENV, "1")
        monkeypatch.setenv(M.ELASTIC_WORLD_ENV, "3")
        monkeypatch.setenv(M.ELASTIC_RPS_ENV, "")
        monkeypatch.delenv(M.ELASTIC_REJOIN_ENV, raising=False)
        c = M.ElasticCluster.from_env()
        rec = [c.rank, c.world, c.epoch, type(c._transport).__name__,
               M.ElasticCluster.rejoining_by_env(), M.current_epoch()]
        monkeypatch.setenv(M.ELASTIC_REJOIN_ENV, "1")
        c._commit(3, [0, 1])
        rec += [M.ElasticCluster.rejoining_by_env(), M.current_epoch()]
        s = M.ElasticCluster(rank=0, world=1,
                             transport=f"file:{tmp_path / impl}")
        rec.append(type(s._transport).__name__)
        monkeypatch.delenv(M.ELASTIC_DIR_ENV)
        with pytest.raises(CL.ClusterError, match="supervisor contract"):
            M.ElasticCluster.from_env()
        out[impl] = rec
    assert out["torch"] == out["jax"]
    monkeypatch.delenv(TM.ELASTIC_RANK_ENV)
    monkeypatch.delenv(TM.ELASTIC_WORLD_ENV)
    monkeypatch.setenv(TM.ELASTIC_DIR_ENV, str(tmp_path / "torch"))
    monkeypatch.setenv("DEAR_PROCESS_ID", "2")
    monkeypatch.setenv("DEAR_NUM_PROCESSES", "2")
    c = TM.ElasticCluster.from_env()
    assert (c.rank, c.joining) == (2, True)   # a scale-up id


# -- the scale policy on a fake clock (JAX test_elastic.py:1444-1519) ---------


def _policy_story(SC, path):
    """The JAX package's four policy tests (hysteresis, the explicit
    drain, waiting out a draining rank, the anomaly veto) as one record
    of every decision on a fake clock."""
    cap = str(path / "cap.json")

    def write(doc):
        with open(cap + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(cap + ".tmp", cap)

    def dec(d):
        return None if d is None else list(d)

    clk = {"t": 0.0}
    out = []
    pol = SC.ScalePolicy(capacity_file=cap, hysteresis_s=1.0, max_world=4,
                         clock=lambda: clk["t"])
    out.append(dec(pol.decide(live_world=2, live_ranks=(0, 1))))
    write({"target_world": 3})
    for t in (0.0, 0.5, 1.1):
        clk["t"] = t
        out.append(dec(pol.decide(live_world=2, live_ranks=(0, 1))))
    write({"target_world": 2})
    for t in (1.2, 2.5):
        clk["t"] = t
        out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    out.append([d.kind for d in pol.decisions])
    clk["t"] = 0.0
    pol = SC.ScalePolicy(capacity_file=cap, hysteresis_s=100.0,
                         clock=lambda: clk["t"])
    write({"target_world": 3, "drain": [1]})
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2),
                              draining=(1,))))
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    write({"target_world": 3})
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    write({"target_world": 3, "drain": [1]})
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    pol = SC.ScalePolicy(capacity_file=cap, hysteresis_s=0.1,
                         clock=lambda: clk["t"])
    write({"target_world": 3, "drain": [0]})
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2))))
    clk["t"] = 1.0
    out.append(dec(pol.decide(live_world=3, live_ranks=(0, 1, 2),
                              draining=(0,))))
    clk["t"] = 2.0
    out.append(dec(pol.decide(live_world=2, live_ranks=(1, 2))))
    clk["t"] = 0.0
    write({"target_world": 3})
    pol = SC.ScalePolicy(capacity_file=cap, hysteresis_s=0.1,
                         anomaly_veto_s=5.0, clock=lambda: clk["t"])
    pol.decide(live_world=2, live_ranks=(0, 1))
    pol.note_anomaly("loss_spike")
    for t in (0.5, 3.0, 5.5):
        clk["t"] = t
        out.append(dec(pol.decide(live_world=2, live_ranks=(0, 1))))
    out.append(list(SC.read_capacity_file(cap)))
    return out


def test_scale_policy_matches_jax(tmp_path):
    out = {}
    for name, SC in (("jax", JSC), ("torch", TSC)):
        (tmp_path / name).mkdir()
        out[name] = _policy_story(SC, tmp_path / name)
    assert out["torch"] == out["jax"]
    assert out["jax"][3] is not None   # the story moved


# -- the object store (JAX test_elastic.py:1230) ------------------------------


def _store_story(OS, root):
    s = OS.LocalObjectStore(str(root))
    s.put_bytes("a/b/one", b"1")
    s.put_bytes("a/b/two", b"22")
    s.put_bytes("a/c", b"333")
    src = root.parent / f"{root.name}_src.bin"
    src.write_bytes(b"payload")
    s.put_file("f/x.bin", str(src))
    dest = root.parent / f"{root.name}_dest.bin"
    s.get_file("f/x.bin", str(dest))
    out = [s.list("a"), s.list("a/b"), s.list("nothing"),
           s.get_bytes("a/b/two").decode(), dest.read_bytes().decode(),
           s.exists("a/c"), s.exists("a/zzz"),
           s.put_bytes_if_absent("once", b"first"),
           s.put_bytes_if_absent("once", b"second"),
           s.get_bytes("once").decode()]
    try:
        s.get_bytes("missing")
    except KeyError:
        out.append("KeyError")
    s.delete_prefix("a/b")
    out.append(s.list("a"))
    return out


def test_local_object_store_matches_jax(tmp_path):
    out = {name: _store_story(OS, tmp_path / name)
           for name, OS in (("jax", JOS), ("torch", TOS))}
    assert out["torch"] == out["jax"]
    assert out["jax"][0] == ["a/b/one", "a/b/two", "a/c"]

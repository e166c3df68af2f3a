"""The port's M2Flow core (``repro_torch.core``, ``repro_torch.comm``) on
the cases of the JAX package's core tests: channels, device lock,
workers, router, flowgraph, split/coalesce, cluster, teardown hygiene."""
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.comm.primitives import Router, reset_router
from repro_torch.core import (
    Channel,
    ChannelClosed,
    Cluster,
    DeviceLock,
    FlowGraph,
    GraphTracer,
    Worker,
    WorkerFailure,
    WorkerGroup,
)
from repro_torch.core.pipeline import coalesce, split_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the port's copies of JAX-free modules: only their imports (and a
# docstring line naming the counterpart) may differ
COPIES = ["obs/trace.py", "obs/metrics.py", "utils/logging.py",
          "train/data.py", "rl/reward.py", "rl/advantage.py",
          "core/placement.py", "core/profiler.py", "core/faults.py",
          "core/channel.py", "core/simulator.py", "core/switching.py",
          "core/pipeline.py"]


@pytest.fixture(autouse=True)
def fresh_state():
    reset_router()
    Channel.reset_all()
    yield
    reset_router()
    Channel.reset_all()


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------
def test_channel_fifo_and_close():
    ch = Channel.create("c1")
    for i in range(5):
        ch.put(i)
    assert [ch.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    ch.close()
    with pytest.raises(ChannelClosed):
        ch.get()


def test_channel_weighted_load_balancing():
    ch = Channel.create("c2")
    for i, w in enumerate([5.0, 1.0, 1.0, 5.0]):
        ch.put(i, weight=w)
    ch.get(consumer="a")  # weight 5 -> a
    ch.get(consumer="b")  # weight 1 -> b
    assert ch.balanced_consumer() == "b"


def test_channel_custom_policy():
    ch = Channel.create("c3")
    for i in (3, 1, 2):
        ch.put(i)
    # policy: always pick the smallest item
    got = ch.get(policy=lambda items: int(np.argmin(items)))
    assert got == 1


def test_channel_get_batch_coalesces():
    ch = Channel.create("c4")
    for i in range(6):
        ch.put(i)
    assert ch.get_batch(min_items=4) == [0, 1, 2, 3]


def test_channel_producer_consumer_threads():
    ch = Channel.create("c5", capacity=2)
    out = []

    def produce():
        for i in range(20):
            ch.put(i)
        ch.close()

    def consume():
        while True:
            try:
                out.append(ch.get())
            except ChannelClosed:
                return

    tp, tc = threading.Thread(target=produce), threading.Thread(target=consume)
    tp.start(); tc.start(); tp.join(); tc.join()
    assert out == list(range(20))


# ---------------------------------------------------------------------------
# Device lock (context switching)
# ---------------------------------------------------------------------------
def test_device_lock_priority_order():
    """Consumers (higher rank) must not grab the lock while a producer
    (lower rank) is waiting — the dependency-ordered acquisition."""
    lock = DeviceLock("L")
    lock.set_priority("producer", 0, devices=(0, 1))
    lock.set_priority("consumer", 1, devices=(0, 1))
    order = []

    lock.acquire("consumer")  # consumer grabs first (nothing else waiting)
    done = threading.Event()

    def producer():
        lock.acquire("producer")
        order.append("producer")
        lock.release("producer")
        done.set()

    def late_consumer():
        time.sleep(0.05)  # ensure producer is already waiting
        lock.acquire("consumer")
        order.append("consumer2")
        lock.release("consumer")

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=late_consumer)
    t1.start(); t2.start()
    time.sleep(0.05)
    lock.release("consumer")  # now both wait; producer has lower rank
    t1.join(); t2.join()
    assert order == ["producer", "consumer2"]


def test_device_lock_onload_offload_hooks_and_placement_skip():
    lock = DeviceLock("L")
    lock.set_priority("a", 0, devices=(0,))
    lock.set_priority("b", 1, devices=(0,))   # shares device 0 with a
    lock.set_priority("c", 2, devices=(5,))   # disjoint devices
    calls = []
    lock.acquire("a", onload=lambda: calls.append("on-a"))
    lock.release("a", offload=lambda: calls.append("off-a"))
    lock.acquire("b", onload=lambda: calls.append("on-b"))
    lock.release("b", offload=lambda: calls.append("off-b"),
                 next_shares_devices=False)
    # c on different devices: acquiring after b must NOT trigger onload
    lock.acquire("c", onload=lambda: calls.append("on-c"))
    lock.release("c")
    assert "on-b" in calls and "off-a" in calls
    assert "on-c" not in calls  # disjoint placement skips the switch


# ---------------------------------------------------------------------------
# Worker / WorkerGroup
# ---------------------------------------------------------------------------
class EchoWorker(Worker):
    def work(self, x):
        return {"v": x["v"] * 2, "who": self.name}

    def boom(self, x):
        raise ValueError("kaput")


def test_worker_group_dispatch_and_timing():
    cluster = Cluster(num_nodes=1, devices_per_node=4)
    wg = WorkerGroup.launch(EchoWorker, cluster, count=3)
    h = wg.work({"v": np.ones(2)})
    out = h.wait()
    assert len(out) == 3
    assert all((o["v"] == 2).all() for o in out)
    assert h.timing("max") >= 0.0
    wg.shutdown()


def test_worker_failure_handler_fires():
    cluster = Cluster()
    wg = WorkerGroup.launch(EchoWorker, cluster, count=1)
    failures = []
    wg.on_failure(failures.append)
    h = wg.boom({"v": 1})
    with pytest.raises(WorkerFailure):
        h.wait()
    assert failures and failures[0].worker == "EchoWorker/0"
    wg.shutdown()


def test_worker_offload_onload_roundtrip():
    w = Worker("w/0", devices=(0,), device="cpu")
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    w.register_state("params", tree)
    before = w.state_bytes()
    w.offload()
    assert w.offloaded
    w.onload()
    got = w.get_state("params")
    np.testing.assert_array_equal(np.asarray(got["a"]),
                                  np.arange(6.0).reshape(2, 3))
    assert w.state_bytes() == before
    w.shutdown()


def test_router_send_recv_and_stats():
    r = Router()
    r.register("a", devices=[0])
    r.register("b", devices=[1])
    r.send("a", "b", {"x": np.ones(3)})
    got = r.recv("b", "a")
    np.testing.assert_array_equal(got["x"], np.ones(3))
    st = r.stats()
    assert st["a->b"]["messages"] == 1 and st["a->b"]["bytes"] >= 24


# ---------------------------------------------------------------------------
# FlowGraph
# ---------------------------------------------------------------------------
def test_trace_to_graph():
    tr = GraphTracer()
    tr.record("put", "rollout", "ch1", 0.0, nbytes=100)
    tr.record("get", "inference", "ch1", 0.1)
    tr.record("put", "inference", "ch2", 0.2, nbytes=50)
    tr.record("get", "train", "ch2", 0.3)
    g = tr.graph()
    assert set(g.edges()) == {("rollout", "inference"),
                              ("inference", "train")}


def test_condense_collapses_cycles():
    g = FlowGraph()
    for n in ("sim", "gen", "train"):
        g.add_worker(n)
    g.add_edge("sim", "gen")
    g.add_edge("gen", "sim")
    g.add_edge("gen", "train")
    dag, members = g.condense()
    assert len(dag.nodes) == 2
    cyc = [n for n in dag.nodes if n.startswith("cycle")][0]
    assert set(members[cyc]) == {"gen", "sim"}


def test_st_cuts_are_downsets():
    g = FlowGraph()
    for n in "abcd":
        g.add_worker(n)
    g.add_edge("a", "b")
    g.add_edge("b", "c")
    g.add_edge("b", "d")
    cuts = list(g.st_cuts())
    assert cuts
    for s, t in cuts:
        # no edge from t to s
        for (u, v) in g.edges():
            assert not (u in t and v in s), (s, t, u, v)
    # chain prefix {a}, {a,b}, and {a,b,c}/{a,b,d} must all appear
    ss = {tuple(sorted(s)) for s, _ in cuts}
    assert ("a",) in ss and ("a", "b") in ss
    assert ("a", "b", "c") in ss and ("a", "b", "d") in ss


# ---------------------------------------------------------------------------
# split/coalesce (elastic pipelining granularity)
# ---------------------------------------------------------------------------
def test_split_coalesce_roundtrip():
    batch = {"x": np.arange(24).reshape(12, 2), "y": np.ones(12)}
    chunks = split_batch(batch, 4)
    assert len(chunks) == 3
    back = coalesce(chunks)
    np.testing.assert_array_equal(back["x"], batch["x"])
    np.testing.assert_array_equal(back["y"], batch["y"])


def test_coalesce_sums_scalar_counters():
    """Regression: integral counters (e.g. SimulatorWorker's `successes`)
    used to keep only the LAST chunk's value — undercounted under any
    pipelined plan.  Integer scalars must sum; float statistics (means,
    ratios, losses) and dicts/metrics keep last-chunk semantics."""
    chunks = [
        {"x": np.ones((2, 3)), "successes": 3, "rate": 0.25,
         "count0d": np.int64(2), "metrics": {"loss": 1.0}, "tag": "a",
         "flag": True},
        {"x": np.zeros((2, 3)), "successes": 4, "rate": 0.5,
         "count0d": np.int64(5), "metrics": {"loss": 2.0}, "tag": "b",
         "flag": False},
    ]
    out = coalesce(chunks)
    assert out["successes"] == 7          # int counter: summed
    assert out["count0d"] == 7            # 0-d integer array: summed
    assert out["rate"] == 0.5             # float statistic: NOT summed
    assert out["metrics"] == {"loss": 2.0}  # dict: keep last
    assert out["tag"] == "b"              # string: keep last
    assert out["flag"] is False           # bool is not a counter
    assert out["x"].shape == (4, 3)


def test_coalesce_single_chunk_passthrough():
    out = coalesce([{"successes": 5, "m": {"a": 1}}])
    assert out["successes"] == 5 and out["m"] == {"a": 1}


# ---------------------------------------------------------------------------
# Cluster: exclusive allocation (regression — the flag must persist)
# ---------------------------------------------------------------------------
def test_exclusive_allocation_blocks_later_nonexclusive_overlap():
    c = Cluster(num_nodes=1, devices_per_node=4)
    c.allocate("trainer", 2, device_ids=[0, 1], exclusive=True)
    # regression: a later NON-exclusive pin on an exclusively-held device
    # must be rejected (previously the exclusive flag was never recorded)
    with pytest.raises(ValueError, match="exclusively held"):
        c.allocate("rollout", 1, device_ids=[1])


def test_exclusive_allocation_rejects_occupied_devices():
    c = Cluster(num_nodes=1, devices_per_node=4)
    c.allocate("rollout", 2, device_ids=[0, 1])  # non-exclusive
    with pytest.raises(ValueError, match="occupied"):
        c.allocate("trainer", 1, device_ids=[0], exclusive=True)


def test_auto_allocation_skips_exclusive_devices():
    c = Cluster(num_nodes=1, devices_per_node=4)
    c.allocate("trainer", 2, exclusive=True)  # takes 0, 1
    ids = c.allocate("rollout", 2)  # auto: must avoid 0 and 1
    assert set(ids) == {2, 3}
    # exhaustion: a further exclusive request cannot be satisfied
    with pytest.raises(ValueError, match="cannot allocate"):
        c.allocate("infer", 1, exclusive=True)


def test_free_releases_exclusivity():
    c = Cluster(num_nodes=1, devices_per_node=2)
    c.allocate("trainer", 1, device_ids=[0], exclusive=True)
    c.free("trainer")
    ids = c.allocate("rollout", 1, device_ids=[0])  # now legal again
    assert ids == [0]


def test_nonexclusive_overlap_still_allowed():
    """Temporal multiplexing (two workers on one device) must survive."""
    c = Cluster(num_nodes=1, devices_per_node=2)
    c.allocate("a", 1, device_ids=[0])
    c.allocate("b", 1, device_ids=[0])
    assert c.collocated("a", "b")


# ---------------------------------------------------------------------------
# Router.broadcast: pack once, share leaves, account per destination
# ---------------------------------------------------------------------------
def test_broadcast_shares_leaves_and_counts_bytes_per_destination():
    r = Router()
    for name in ("src", "d1", "d2", "d3"):
        r.register(name, devices=[0])
    payload = {"w": np.arange(6, dtype=np.float32)}
    r.broadcast("src", ["d1", "d2", "d3"], payload)
    got = [r.recv(d, "src") for d in ("d1", "d2", "d3")]
    for g in got:
        np.testing.assert_array_equal(g["w"], payload["w"])
    # zero-copy fan-out: every destination sees the SAME leaf buffer
    assert got[0]["w"] is got[1]["w"] is got[2]["w"]
    st = r.stats()
    for d in ("d1", "d2", "d3"):
        assert st[f"src->{d}"]["messages"] == 1
        assert st[f"src->{d}"]["bytes"] == 24  # 6 x float32 each


def test_broadcast_cross_device_hosts_leaves_once():
    r = Router()
    r.register("src", devices=[0])
    r.register("same", devices=[0])
    r.register("far1", devices=[1])
    r.register("far2", devices=[2])
    obj = {"w": torch.ones(4)}
    r.broadcast("src", ["same", "far1", "far2"], obj)
    same = r.recv("same", "src")
    far1 = r.recv("far1", "src")
    far2 = r.recv("far2", "src")
    assert same["w"] is obj["w"]                  # zero-copy reference
    assert far1["w"] is not obj["w"]              # host transfer: a copy
    assert far1["w"].device.type == "cpu"
    torch.testing.assert_close(far1["w"], obj["w"])
    # the host copy is made once and shared across far destinations
    assert far1["w"] is far2["w"]
    st = r.stats()
    assert st["src->far1"]["bytes"] == st["src->far2"]["bytes"] == 16


# ---------------------------------------------------------------------------
# teardown hygiene (satellites): reset_all closes live channels, and the
# executor's thread-leak check catches wedged threads by name
# ---------------------------------------------------------------------------
def test_reset_all_closes_live_channels_and_wakes_getters():
    ch = Channel.create("orphaned")
    outcome = []

    def getter():
        try:
            ch.get(timeout=30.0)
            outcome.append("item")
        except ChannelClosed:
            outcome.append("closed")

    th = threading.Thread(target=getter)
    th.start()
    time.sleep(0.05)  # let the getter park on the empty channel
    Channel.reset_all()
    th.join(timeout=5.0)
    assert not th.is_alive(), "reset_all left a getter blocked"
    assert outcome == ["closed"]
    assert ch.closed
    with pytest.raises(KeyError):
        Channel.get_channel("orphaned")


def test_assert_no_leaked_threads_passes_when_clean():
    from repro_torch.core.pipeline import assert_no_leaked_threads

    assert_no_leaked_threads(grace=0.01)


def test_assert_no_leaked_threads_flags_wedged_executor_thread():
    from repro_torch.core.pipeline import ThreadLeakError, assert_no_leaked_threads

    stop = threading.Event()
    th = threading.Thread(target=stop.wait, name="pipe-prod-leaktest",
                          daemon=True)
    th.start()
    try:
        with pytest.raises(ThreadLeakError) as ei:
            assert_no_leaked_threads(grace=0.05)
        assert ei.value.thread_names == ["pipe-prod-leaktest"]
    finally:
        stop.set()
        th.join(timeout=5.0)
    assert_no_leaked_threads(grace=0.5)  # clean again once it exited


def test_runner_teardown_runs_leak_check(tmp_path):
    from repro_torch.core.pipeline import ThreadLeakError
    from repro_torch.rl.runner import WorkflowRunner

    stop = threading.Event()
    th = threading.Thread(target=stop.wait, name="cycle-member-leaktest",
                          daemon=True)
    th.start()
    try:
        import types

        runner = WorkflowRunner.__new__(WorkflowRunner)
        runner.workers = {}
        runner.cluster = Cluster(num_nodes=1, devices_per_node=2)
        runner.controller = types.SimpleNamespace(
            placement_manager=types.SimpleNamespace(
                release_all=lambda: None),
            _switcher=None, profiles={},
            reset_failures=lambda: None)
        with pytest.raises(ThreadLeakError):
            runner.teardown()
    finally:
        stop.set()
        th.join(timeout=5.0)


# ---------------------------------------------------------------------------
# the copies stay copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_from_the_jax_module_only_in_imports(rel):
    ours = (ROOT / "src" / "repro_torch" / rel).read_text()
    theirs = (ROOT / "src" / "repro" / rel).read_text()
    note = (f"\n\nA copy of the JAX package's ``{rel}``; only its imports\n"
            "differ.\n")
    assert note in ours
    ours = ours.replace(note, "").replace("repro_torch.", "repro.")

    def docstring_closed(s):  # the module docstring without its last newline
        end = s.index('"""', 3)
        return s[:end].rstrip() + s[end:]

    assert docstring_closed(ours) == docstring_closed(theirs)

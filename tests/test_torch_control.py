"""Port parity, the fleet's control plane (`repro_torch.serve.control`): the
cases of `tests/test_control.py` on the port (wire serialization, the
FleetState judgements: seq gating, credits against herding, staleness that
is not death, terminal death, `max_inflight`, no flap under delayed
snapshots; the socket transport), the bytes `encode_message` puts on the
wire against JAX's for the same messages (numpy and torch integer blocks
among them), and the port's socket ends talking to JAX's.

Everything here is deterministic on a caller-advanced clock: no model, no
subprocess."""

import time

import numpy as np
import pytest

from torch_serve_parity import needs_jax, torch

from repro_torch.serve.control import (ControlListener, FleetConfig,
                                       FleetState, ProcessStatus, connect,
                                       decode_message, encode_message)


# ------------------------------------------------------------ serialization

def test_encode_decode_roundtrip_all_field_types():
    msg = {
        "kind": "submit",
        "rid": np.int64(7),
        "prompt": np.arange(5, dtype=np.int32),
        "temperature": np.float32(0.25),
        "eos_id": None,
        "flag": True,
        "name": "req-7",
        "nested": {"loads": [np.int32(1), 2], "occ": np.float64(0.5)},
        "tuple_field": (1, 2, 3),
        "tokens": torch.arange(3, dtype=torch.int32),
        "last": torch.tensor(9),
    }
    out = decode_message(encode_message(msg))
    assert out["kind"] == "submit"
    assert out["rid"] == 7
    assert out["prompt"] == [0, 1, 2, 3, 4]
    assert out["temperature"] == pytest.approx(0.25)
    assert out["eos_id"] is None
    assert out["flag"] is True
    assert out["name"] == "req-7"
    assert out["nested"] == {"loads": [1, 2], "occ": 0.5}
    assert out["tuple_field"] == [1, 2, 3]
    assert out["tokens"] == [0, 1, 2] and out["last"] == 9
    # one message per line, newline-terminated
    assert encode_message(msg).endswith(b"\n")
    assert encode_message(msg).count(b"\n") == 1


def test_encode_requires_kind():
    with pytest.raises(ValueError):
        encode_message({"rid": 1})
    with pytest.raises(ValueError):
        decode_message(b"[1, 2, 3]")


def test_process_status_wire_roundtrip():
    st = ProcessStatus(process_index=3, seq=11, step=42,
                       replica_loads=[2, 5], n_free_slots=1, n_waiting=4,
                       page_occupancy=0.75, qos_tier=1, submits_seen=9,
                       progress={"12": [101, 102], "13": [7]})
    back = ProcessStatus.from_wire(
        decode_message(encode_message(st.to_wire())))
    assert back == st
    assert back.load == 7


def test_from_wire_ignores_unknown_fields():
    st = ProcessStatus(process_index=0, seq=1, step=0, replica_loads=[0],
                       n_free_slots=4, n_waiting=0, page_occupancy=0.0,
                       qos_tier=0, submits_seen=0)
    wire = st.to_wire()
    wire["future_field"] = "whatever"   # forward compatibility
    assert ProcessStatus.from_wire(wire) == st


# messages of every kind, each as the port may hold it (torch values) and
# as the JAX package holds it (numpy values)
_STATUS = dict(process_index=1, seq=4, step=17, replica_loads=[2, -1],
               n_free_slots=3, n_waiting=1, page_occupancy=0.25, qos_tier=0,
               submits_seen=5, progress={"0": [11, 12], "3": [7]})
WIRE_CASES = {
    "submit": ({"kind": "submit", "rid": 3,
                "prompt": torch.tensor([5, 6, 7], dtype=torch.int32),
                "max_new_tokens": 8, "arrival_step": 2, "temperature": 0.0,
                "eos_id": None, "failover_from": -1},
               {"kind": "submit", "rid": 3,
                "prompt": np.array([5, 6, 7], np.int32),
                "max_new_tokens": 8, "arrival_step": 2, "temperature": 0.0,
                "eos_id": None, "failover_from": -1}),
    "done": ({"kind": "done", "rid": np.int64(4), "process_index": 1,
              "state": "done",
              "tokens": [torch.tensor(3), torch.tensor(250)]},
             {"kind": "done", "rid": np.int64(4), "process_index": 1,
              "state": "done", "tokens": np.array([3, 250], np.int64)}),
    "numpy block": ({"kind": "x", "block": np.arange(6).reshape(2, 3),
                     "f": np.float32(0.5)},
                    {"kind": "x", "block": np.arange(6).reshape(2, 3),
                     "f": np.float32(0.5)}),
    "torch block": ({"kind": "x",
                     "block": torch.arange(6, dtype=torch.int64)
                     .reshape(2, 3)},
                    {"kind": "x", "block": np.arange(6).reshape(2, 3)}),
    "hello": ({"kind": "hello", "process_index": 0, "v": 1,
               "n_replicas": 2},) * 2,
}


@needs_jax
@pytest.mark.parametrize("case", sorted(WIRE_CASES) + ["status"])
def test_wire_bytes_equal_jax(case):
    """The bytes the port puts on the wire equal JAX's for the same
    message: the two ends of a fleet may be either package."""
    from repro.serve import control as jc
    if case == "status":
        got = encode_message(ProcessStatus(**_STATUS).to_wire())
        want = jc.encode_message(jc.ProcessStatus(**_STATUS).to_wire())
    else:
        port_msg, jax_msg = WIRE_CASES[case]
        got, want = encode_message(port_msg), jc.encode_message(jax_msg)
    assert got == want


# ------------------------------------------------------------------- config

def test_fleet_config_invariant():
    FleetConfig(staleness=4.0, heartbeat_timeout=10.0)   # fine
    with pytest.raises(ValueError):
        FleetConfig(staleness=11.0, heartbeat_timeout=10.0)
    with pytest.raises(ValueError):
        FleetConfig(staleness=0.0)


# -------------------------------------------------------------- fleet state

def _status(pi, seq, loads, submits_seen=0):
    return ProcessStatus(process_index=pi, seq=seq, step=seq,
                         replica_loads=list(loads), n_free_slots=0,
                         n_waiting=0, page_occupancy=0.0, qos_tier=0,
                         submits_seen=submits_seen)


def test_observe_seq_gating():
    fs = FleetState()
    assert fs.observe(_status(0, 2, [1]), now=1.0)
    assert not fs.observe(_status(0, 2, [9]), now=2.0)   # duplicate
    assert not fs.observe(_status(0, 1, [9]), now=3.0)   # reordered
    assert fs.status[0].load == 1
    assert fs.last_seen[0] == 1.0                        # ignored != seen


def test_credits_prevent_submit_herding():
    """All submits between two heartbeats must not land on one process:
    the submit credit raises its effective load immediately."""
    fs = FleetState()
    fs.observe(_status(0, 1, [0], submits_seen=0), now=0.0)
    fs.observe(_status(1, 1, [0], submits_seen=0), now=0.0)
    homes = []
    for _ in range(8):
        p = fs.least_loaded(now=1.0)
        fs.note_submit(p)
        homes.append(p)
    assert homes.count(0) == 4 and homes.count(1) == 4
    # and never more than one in a row on the same process
    assert all(a != b for a, b in zip(homes, homes[1:]))


def test_hello_only_process_admissible_at_credit_load():
    """A process that said hello but has not heartbeated yet is admissible
    with load == submits sent: the first status to arrive must not soak up
    the whole backlog."""
    fs = FleetState()
    fs.last_seen[0] = 0.0           # hello
    fs.last_seen[1] = 0.0
    fs.observe(_status(1, 1, [0]), now=0.0)   # only 1 has a snapshot
    homes = [0, 0]
    while not all(homes.count(p) for p in (0, 1)):
        p = fs.least_loaded(now=0.0)
        fs.note_submit(p)
        homes.append(p)
        assert len(homes) < 12
    assert fs.load(0) == fs.submits_sent[0]


def test_staleness_excludes_but_does_not_kill():
    cfg = FleetConfig(staleness=4.0, heartbeat_timeout=25.0)
    fs = FleetState(cfg)
    fs.observe(_status(0, 1, [0]), now=0.0)
    fs.observe(_status(1, 1, [5]), now=10.0)
    # process 0's snapshot is 10 old: excluded from admission, not dead
    assert fs.least_loaded(now=10.0) == 1
    assert not fs.check(now=10.0)
    assert 0 not in fs.dead
    # everyone stale -> no placement, and the refusal is counted
    before = fs.stale_skips
    assert fs.least_loaded(now=30.0) is None
    assert fs.stale_skips == before + 1


def test_heartbeat_timeout_death_is_terminal():
    cfg = FleetConfig(staleness=4.0, heartbeat_timeout=6.0)
    fs = FleetState(cfg)
    fs.observe(_status(0, 1, [0]), now=0.0)
    fs.observe(_status(1, 1, [0]), now=5.0)
    assert fs.check(now=7.0) == [0]          # only 0 crossed the horizon
    assert fs.check(now=7.5) == []           # newly-dead reported ONCE
    # resurrection: a late heartbeat from the dead process is dropped
    assert not fs.observe(_status(0, 99, [0]), now=8.0)
    assert fs.resurrections_ignored == 1
    assert not fs.alive(0) and fs.alive(1)
    assert fs.least_loaded(now=8.0) == 1


def test_max_inflight_caps_admission():
    cfg = FleetConfig(max_inflight=2)
    fs = FleetState(cfg)
    fs.observe(_status(0, 1, [0]), now=0.0)
    for _ in range(2):
        assert fs.least_loaded(now=0.0) == 0
        fs.note_submit(0)
    assert fs.least_loaded(now=0.0) is None  # cap reached, snapshot unmoved
    fs.observe(_status(0, 2, [0], submits_seen=2), now=1.0)
    assert fs.least_loaded(now=1.0) == 0     # snapshot caught up


# ------------------------------------------- delayed-snapshot no-flap replay

def test_no_flap_under_delayed_snapshots():
    """Snapshots arrive D steps late, two submits arrive per step, each
    process drains one request per step. Without the credit term every
    inter-snapshot burst herds onto one process and the next snapshot
    swings it back; with it, placement stays balanced and alternating."""
    D, STEPS = 3, 40
    cfg = FleetConfig(heartbeat_every=1, staleness=float(D + 2),
                      heartbeat_timeout=50.0)
    fs = FleetState(cfg)
    fs.last_seen.update({0: 0.0, 1: 0.0})   # hello, as FleetRouter seeds
    queue = {0: 0, 1: 0}        # worker-side queue depths (ground truth)
    seen = {0: 0, 1: 0}         # worker-side submits_seen at status time
    inflight = []               # (deliver_at, ProcessStatus)
    homes, seq = [], {0: 0, 1: 0}
    for t in range(STEPS):
        # workers: drain one, emit a status that lands D steps later
        for p in (0, 1):
            queue[p] = max(0, queue[p] - 1)
            seq[p] += 1
            inflight.append((t + D, _status(p, seq[p], [queue[p]],
                                            submits_seen=seen[p])))
        for at, st in [x for x in inflight if x[0] <= t]:
            fs.observe(st, now=float(t))
            inflight.remove((at, st))
        # coordinator: two arrivals per step
        for _ in range(2):
            p = fs.least_loaded(now=float(t))
            assert p is not None
            fs.note_submit(p)
            queue[p] += 1
            seen[p] = fs.submits_sent[p]   # worker sees it next status
            homes.append(p)
    warm = homes[2 * D:]                   # after the first snapshots land
    # balanced overall...
    assert abs(warm.count(0) - warm.count(1)) <= 2
    # ...and no herding run longer than one heartbeat+delay window
    run, longest = 1, 1
    for a, b in zip(warm, warm[1:]):
        run = run + 1 if a == b else 1
        longest = max(longest, run)
    assert longest <= D + 1, f"flapping: {longest}-long run in {warm}"


# ---------------------------------------------------------------- transport

def _drain(*endpoints, want=1, timeout=5.0):
    got = [[] for _ in endpoints]
    deadline = time.monotonic() + timeout
    while any(len(g) < want for g in got) and time.monotonic() < deadline:
        for g, ep in zip(got, endpoints):
            g += ep.poll()
        time.sleep(0.005)
    return got


def test_socket_endpoint_roundtrip():
    listener = ControlListener()
    try:
        worker = connect(listener.address)
        coord = listener.accept(timeout=10.0)
        worker.send({"kind": "hello", "process_index": 0})
        coord.send({"kind": "submit", "rid": 0,
                    "prompt": torch.arange(4, dtype=torch.int32),
                    "max_new_tokens": 8})
        got_c, got_w = _drain(coord, worker)
        assert got_c and got_c[0]["kind"] == "hello"
        assert got_w and got_w[0]["prompt"] == [0, 1, 2, 3]
        worker.close()
        deadline = time.monotonic() + 5.0
        while coord.alive and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not coord.alive            # peer hangup is a liveness fact
        assert coord.send({"kind": "stop"}) in (True, False)  # no raise
        coord.close()
    finally:
        listener.close()


@needs_jax
def test_port_worker_end_talks_to_jax_coordinator_end():
    """The port's `connect` dials JAX's ControlListener and each side
    decodes what the other sent: a status from the port, a submit with a
    numpy prompt from JAX."""
    from repro.serve import control as jc
    listener = jc.ControlListener()
    try:
        worker = connect(listener.address)
        coord = listener.accept(timeout=10.0)
        worker.send(ProcessStatus(**_STATUS).to_wire())
        coord.send({"kind": "submit", "rid": 1,
                    "prompt": np.arange(3, dtype=np.int32),
                    "max_new_tokens": 4})
        got_c, got_w = _drain(coord, worker)
        assert jc.ProcessStatus.from_wire(got_c[0]) == \
            jc.ProcessStatus(**_STATUS)
        assert got_w[0]["prompt"] == [0, 1, 2]
        worker.close()
        coord.close()
    finally:
        listener.close()

"""The open loop's schedule, due times and lateness, under a fake clock."""

import functools

import numpy as np

from portbench.drivers.open_loop import offer, schedule, wait_until


class FakeClock:
    """Moves when slept on, and by 0.1 us at each read (a spin moves on)."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-7
        return self.t

    def sleep(self, dt):
        self.t += dt


class FakeOutcome:
    def __init__(self):
        self.outcome = "queued"
        self.results = []


class FakeServer:
    """Answers in batches of two, each dispatch taking ``cost`` seconds of
    the fake clock; sheds every fifth query."""

    def __init__(self, clock, cost=0.004):
        self.clock, self.cost = clock, cost
        self.queue, self.n, self.arrivals = [], 0, []

    def submit(self, basket, t_arrival, tenant):
        self.arrivals.append(t_arrival)
        out = FakeOutcome()
        self.n += 1
        if self.n % 5 == 0:
            out.outcome = "shed"
            return out
        self.queue.append(out)
        if len(self.queue) == 2:
            self.flush()
        return out

    def flush(self, now=None):
        if self.queue:
            self.clock.sleep(self.cost)
        for o in self.queue:
            o.outcome = "served"
        self.queue = []


def test_schedule_is_fixed_work_in_seed_order():
    slices = {"a": np.eye(4, dtype=bool), "b": np.ones((3, 4), bool)}
    due, tenants, baskets = schedule(np.random.default_rng(5), 200.0, 2.0,
                                     slices)
    assert due.size == 400 and len(tenants) == len(baskets) == 400
    assert (np.diff(due) >= 0).all() and 0 <= due[0] and due[-1] < 2.0
    assert set(tenants) == {"a", "b"}
    for t, b in zip(tenants, baskets):
        assert len(b) == (1 if t == "a" else 3)
    again = schedule(np.random.default_rng(5), 200.0, 2.0, slices)
    assert np.array_equal(again[0], due) and again[2] == baskets


def test_wait_until_sleeps_then_returns_at_due():
    clock = FakeClock()
    wait_until(100.25, clock, clock.sleep)
    assert 100.25 <= clock.t < 100.25002


close = functools.partial(np.isclose, rtol=0.0, atol=2e-5)


def test_latency_runs_from_due_time_and_lateness_is_counted():
    clock = FakeClock()
    server = FakeServer(clock, cost=0.004)
    due = np.array([0.0, 0.001, 0.002, 0.010, 0.0105, 0.020])
    got = offer(server, due, ["t"] * 6, [[1]] * 6, clock, clock.sleep)
    t0 = got["t0"]
    assert close(t0, 100.0 + 1e-3)
    # q0 waits for q1; q1 pairs it at 0.001 and both return 4 ms later
    assert close(got["done"][0], t0 + 0.005)
    assert close(got["done"][1], t0 + 0.005)
    # q2 was due at 0.002 but the caller was busy until 0.005
    assert close(got["late"][2], 0.003)
    assert close(server.arrivals[2], 0.005)
    # q4 (the fifth) is shed: never answered
    assert np.isnan(got["done"][4])
    assert [o.outcome for o in got["outcomes"]] == [
        "served", "served", "served", "served", "shed", "served"]
    # q5 is flushed at the end of the stream
    assert close(got["done"][5], t0 + 0.020 + 0.004)
    assert close(got["t1"], got["done"][5])

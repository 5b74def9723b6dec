"""What the port's subprocess batteries share, and its tests.

The batteries (``test_torch_distributed.py``, ``test_torch_hier_distributed.py``
and the ``test_torch_tp*.py`` files) start the reference's train steps in
a JAX subprocess on a host mesh beside the port's gloo ranks, all at
once in a module-scoped fixture.  Two things keep them inside the
suite's clock:

  * :class:`Spawned` starts them and waits on each one only when a test
    reads its results, within a deadline counted from the start: a
    subprocess that runs past it is killed, and each test that reads it
    fails naming it, while the tests that read the others run on.  Its
    output goes to files, so that no pipe fills while it waits;
    :class:`Lazy` hands a fixture's results to the tests by index, each
    one computed (its subprocesses waited on) when first read.
  * :data:`COMPILE_ONCE` is prepended to each JAX subprocess script.  A
    step of the reference's ``build_train_step`` is jitted; its first
    call hands back a state laid out otherwise than the state it took,
    so ``jax.jit`` compiles the same step a second time for the second
    call.  ``compile_once(step)`` compiles it once, for the first call's
    layouts, and lays each later call's arguments out as that program
    takes them (a copy; the same program runs every step).

Importing this module (every pytest worker collects it) sets torch's
intra-op threads to one: the suite runs several workers on the host's
cores (``-n 6``), each of the port's tests computes small tensors in
its worker, and torch's default of one thread a core in every worker
oversubscribes the host several times over (the gloo ranks already run
with ``OMP_NUM_THREADS=1``).  It changes no comparison: every check
between two torch computations runs them in one process, or against
ranks that run on one thread too.
"""
import collections.abc
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest

try:
    import torch
except ImportError:         # the reference's tests run without torch
    torch = None
else:
    torch.set_num_threads(1)

#: seconds a subprocess may run, from the fixture's start, before the
#: tests that read it fail (the suite's own clock is 1470 s)
DEADLINE = 900

COMPILE_ONCE = '''
def compile_once(step):
    """``step`` (a jitted train step) compiled once, for the layouts of
    its first call's arguments; each call lays its arguments out as
    that program takes them."""
    import jax
    held = {}

    def call(*args):
        if not held:
            comp = step.lower(*args).compile()
            held["fn"], held["in"] = comp, comp.input_shardings[0]
        return held["fn"](*jax.device_put(args, held["in"]))
    return call

'''


class Spawned:
    """Subprocesses started together (``python -c code args``), each
    waited on by :meth:`wait` within ``deadline`` seconds of this
    object's creation; their output goes to files under ``tmp``."""

    def __init__(self, tmp, env: dict, deadline: float = DEADLINE):
        self.tmp, self.env, self.deadline = tmp, env, deadline
        self.t0 = time.monotonic()
        self.procs: dict = {}
        self.fault: dict = {}

    def start(self, name: str, code: str, args=(), **env):
        """Start ``code`` as the subprocess ``name`` (extra ``env``
        variables over the shared ones)."""
        logs = [open(os.path.join(self.tmp, f"{name}.{s}"), "w")
                for s in ("out", "err")]
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-c", code] + [str(a) for a in args],
            env=dict(self.env, **env), stdin=subprocess.DEVNULL,
            stdout=logs[0], stderr=logs[1], text=True)
        for f in logs:
            f.close()

    def _tail(self, name: str) -> str:
        out = []
        for s in ("out", "err"):
            with open(os.path.join(self.tmp, f"{name}.{s}")) as f:
                out.append(f"STD{s.upper()}:\n{f.read()[-6000:]}")
        return "\n".join(out)

    def wait(self, *names: str) -> None:
        """Wait for each of ``names`` (each at most until the deadline);
        fail the calling test, naming the subprocess, when one ran past
        it (then killed) or exited with an error."""
        for name in names:
            p = self.procs[name]
            if name not in self.fault:
                left = self.deadline - (time.monotonic() - self.t0)
                try:
                    p.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    self.fault[name] = (f"ran past its {self.deadline:.0f} s "
                                        f"deadline and was killed")
                else:
                    self.fault[name] = (None if p.returncode == 0 else
                                        f"exited with {p.returncode}")
                if self.fault[name]:
                    self.fault[name] += "\n" + self._tail(name)
            if self.fault[name]:
                pytest.fail(f"subprocess {name!r} {self.fault[name]}",
                            pytrace=False)

    def close(self) -> None:
        """Kill whatever still runs (the fixture's teardown)."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


class Lazy(collections.abc.Sequence):
    """A fixture's results by index, ``results[i]`` computed by
    ``thunks[i]()`` when first read and kept."""

    def __init__(self, *thunks):
        self.thunks, self.done = thunks, {}

    def __len__(self) -> int:
        return len(self.thunks)

    def __getitem__(self, i):
        if i not in self.done:
            self.done[i] = self.thunks[i]()
        return self.done[i]


def load(path) -> dict:
    return dict(np.load(path))


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of one rank in this process (a mesh's
    collectives over it are the identity), destroyed at the end."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            yield
        finally:
            dist.destroy_process_group()


# -- tests of the above ------------------------------------------------------

@pytest.fixture
def spawned(tmp_path):
    sp = Spawned(tmp_path, dict(os.environ), deadline=20)
    yield sp
    sp.close()


def test_a_subprocess_past_its_deadline_fails_only_its_readers(spawned):
    """The slow subprocess's reader fails naming it; the fast one's
    reader passes, before and after."""
    spawned.deadline = 3
    spawned.start("slow", "import time; time.sleep(60)")
    spawned.start("fast", "print('done')")
    spawned.wait("fast")
    with pytest.raises(pytest.fail.Exception,
                       match="subprocess 'slow' ran past its 3 s deadline"):
        spawned.wait("slow")
    spawned.wait("fast")
    assert spawned.procs["slow"].poll() is not None


def test_a_failing_subprocess_fails_its_readers_naming_it(spawned):
    spawned.start("bad", "import sys; print('to stderr', file=sys.stderr); "
                         "sys.exit(3)")
    for _ in range(2):
        with pytest.raises(pytest.fail.Exception,
                           match="(?s)subprocess 'bad' exited with 3.*"
                                 "to stderr"):
            spawned.wait("bad")


def test_lazy_results_are_computed_once_when_read():
    calls = []
    res = Lazy(lambda: calls.append(0) or "a", lambda: calls.append(1) or "b")
    assert calls == [] and len(res) == 2
    assert res[1] == "b" and res[1] == "b" and calls == [1]
    first, second = res
    assert (first, second) == ("a", "b") and calls == [1, 0]


def test_compile_once_runs_the_jitted_step_bit_for_bit():
    """Three steps of a jitted step through ``compile_once`` give the
    bits of the jitted step's own three calls, and compile it once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    scope: dict = {}
    exec(COMPILE_ONCE, scope)
    traced = []

    def make():
        def body(state, batch):
            traced.append(1)
            w = state["w"] - 0.1 * jnp.tanh(state["w"] @ batch).sum(1)
            return {"w": w}, {"loss": (w ** 2).sum()}
        return body

    rng = np.random.default_rng(0)
    state = {"w": rng.standard_normal((8, 8)).astype(np.float32)}
    batches = [rng.standard_normal((8, 4)).astype(np.float32)
               for _ in range(3)]
    want, s, jitted = [], state, jax.jit(make())
    for b in batches:
        s, m = jitted(s, b)
        want.append((np.asarray(s["w"]), float(m["loss"])))
    traced.clear()
    step, s = scope["compile_once"](jax.jit(make())), state
    for b, (w, loss) in zip(batches, want):
        s, m = step(s, b)
        np.testing.assert_array_equal(np.asarray(s["w"]), w)
        assert float(m["loss"]) == loss
    assert len(traced) == 1

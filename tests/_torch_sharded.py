"""Gloo worlds on the CPU for the sharded-fuse tests of
semantic_meshes_torch: a World starts every rank of
tests/_torch_sharded_worker.py at once, each in its own python process
(so no rank imports JAX), on a file:// store in the test's temporary
directory (so parallel test workers never race for a port), and reads
back what each rank wrote for each case."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sharded_worker.py")
TIMEOUT_S = 300


def case(name, layout, inputs, args, **kwargs):
    """One case of a world: make_sharded_fuse(**kwargs) on a
    make_device_mesh(*layout) mesh, called with the arrays named `args`
    of the .npz `inputs`. Keys "repeat" and "face_ids" are the worker's
    (see _torch_sharded_worker.py), the rest make_sharded_fuse's."""
    extra = {k: kwargs.pop(k) for k in ("repeat", "face_ids")
             if k in kwargs}
    return dict(name=name, layout=list(layout), inputs=str(inputs),
                args=list(args), kwargs=kwargs, **extra)


class World:
    """`n` ranks running `cases` in order; they start when the World is
    made, and the first read waits for them. `store`: the rendezvous
    (initialize_multihost's coordinator_address), by default a file://
    store in `tmp`. `worker`: the rank's script (the sharded-fuse worker
    by default; tests/_torch_train_worker.py takes the same arguments)."""

    def __init__(self, tmp, cases, n=4, store=None, worker=WORKER):
        self.n = n
        self.out = tmp / "out"
        self.out.mkdir()
        (tmp / "cases.json").write_text(json.dumps(cases))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        self.procs = [
            subprocess.Popen(
                [sys.executable, worker, "--rank", str(r), "--world", str(n),
                 "--store", store or f"file://{tmp}/store", "--cases",
                 str(tmp / "cases.json"), "--out", str(self.out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO)
            for r in range(n)]
        self.logs = None

    def wait(self):
        if self.logs is None:
            try:
                self.logs = [p.communicate(timeout=TIMEOUT_S)[0]
                             for p in self.procs]
            finally:
                self.close()
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, f"rank {r}:\n{self.logs[r]}"

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def ranks(self, name):
        """What each rank wrote for case `name`, in rank order (rank r has
        mesh coordinates r in row-major order)."""
        self.wait()
        return [dict(np.load(self.out / f"{name}.rank{r}.npz"))
                for r in range(self.n)]

    def replicated(self, name):
        """(accumulator, overflow) of a replicated fuse, checked equal on
        every rank and bit-identical between the runs each rank made."""
        ranks = self.ranks(name)
        acc, ov = ranks[0]["acc0"], int(ranks[0]["overflow0"])
        for r in ranks:
            for k in range(2):
                if f"acc{k}" in r:
                    np.testing.assert_array_equal(r[f"acc{k}"], acc)
                    assert int(r[f"overflow{k}"]) == ov
        return acc, ov

    def collectives(self, name, rank=0):
        return json.loads(str(self.ranks(name)[rank]["collectives"]))


def jax_sharded(layout, *args, **kwargs):
    """(accumulator, overflow) of the JAX package's make_sharded_fuse on
    the first prod(layout) virtual CPU devices in `layout`, the same
    (views, pixels[, faces]) layout as a World's mesh."""
    import jax
    from jax.sharding import Mesh

    from semantic_meshes import distributed as jdist

    names = ("views", "pixels", "faces")[:len(layout)]
    devices = np.array(jax.devices()[:int(np.prod(layout))])
    mesh = Mesh(devices.reshape(layout), names)
    fuse = jdist.make_sharded_fuse(mesh, **kwargs)
    with mesh:
        acc, overflow = fuse(*args)
    return np.asarray(acc), int(overflow)

"""Teardown of the port's spawned gloo ranks (tests/test_torch_dear.py
`spawn_ranks`): each rank must release its process group before its
interpreter exits. A gloo group still referenced then is destroyed during
finalization, and that teardown now and then aborts the rank after its
work is done ("terminate called without an active exception", SIGABRT),
which failed test_collectives_match_jax[4] in a loaded run.

The test checks the mechanism deterministically: at exit (an ``atexit``
hook, which runs after the script) a rank whose script kept its group in a
module-level name has no gloo thread left. Run as a script, this file is
the stress that shows the abort: ``--rounds`` rounds of ``--parallel``
concurrent worlds of ``--world`` ranks, each rank the worker of
tests/test_torch_collectives.py, counting the worlds in which a rank
failed; ``--raw`` runs each rank's script with its globals alive at exit,
as the harness did before, to show what the release prevents.

  python tests/test_torch_spawn_teardown.py --rounds 50 --parallel 6 [--raw]
"""

import argparse
import os
import shutil
import sys
import tempfile
import threading
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests import test_torch_dear  # noqa: E402
from tests.test_torch_collectives import _WORKER, _inputs  # noqa: E402


_HOLDER = '''
import atexit, os, sys
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.comm import backend

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
g = backend.init("cpu")          # held at module level, as the workers do
backend.barrier()
backend.shutdown()


def threads(path):     # at exit, after the harness has run the script
    import os
    names = [open(f"/proc/self/task/{{t}}/comm").read().strip()
             for t in os.listdir("/proc/self/task")]
    with open(path, "w") as f:
        f.write("\\n".join(names))


atexit.register(threads, f"{{out}}/threads{{rank}}.txt")
'''


def test_spawned_ranks_release_their_group_before_exit(tmp_path):
    out = str(tmp_path)
    test_torch_dear.spawn_ranks(_HOLDER.format(root=ROOT), 2, out)
    for rank in range(2):
        names = open(os.path.join(out, f"threads{rank}.txt")).read().split()
        assert names
        assert not [n for n in names if "gloo" in n], names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--raw", action="store_true",
                    help="run each rank's script directly (no release)")
    args = ap.parse_args(argv)
    base = tempfile.mkdtemp(prefix="torch_spawn_stress_")
    # --raw: as `python worker.py ...`, the script's globals alive at exit
    raw = ("import sys\npath = sys.argv.pop(1)\n"
           "ns = {'__name__': '__main__', '__file__': path}\n"
           "exec(compile(open(path).read(), path, 'exec'), ns)\n")
    main_code = raw if args.raw else test_torch_dear._RANK_MAIN
    failures = []

    def one(tag):
        out = os.path.join(base, tag)
        os.makedirs(out)
        x, m, ints = _inputs(args.world)
        np.savez(os.path.join(out, "inputs.npz"), x=x, m=m, ints=ints)
        try:
            test_torch_dear.spawn_ranks(_WORKER.format(root=ROOT),
                                        args.world, out)
        except AssertionError as e:
            failures.append(f"{tag}: {e}")
        shutil.rmtree(out, ignore_errors=True)

    with mock.patch.object(test_torch_dear, "_RANK_MAIN", main_code):
        for r in range(args.rounds):
            threads = [threading.Thread(target=one, args=(f"r{r}p{p}",))
                       for p in range(args.parallel)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    for f in failures:
        print(f)
    runs = args.rounds * args.parallel
    print(f"{'raw' if args.raw else 'spawn_ranks'}: {len(failures)} of {runs} "
          f"world-{args.world} runs failed")
    shutil.rmtree(base, ignore_errors=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

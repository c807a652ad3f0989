"""The two-process step of tests/test_torch_parallel.py over several seeds
of its inputs, on the CPU: for each seed and case, the NeuS variances'
gradient distances from the one-process step (over their scale) and the
largest distance of any other gradient, one JSON line each. It is how that
test's VARIANCE_RTOL was read off; run it on a copy with a planted fault to
see what a fault reads.

Usage (from the repository root):
  JAX_PLATFORMS=cpu python3 tests/_torch_parallel_sweep.py 0,1,2,3,4,5,6,7
"""
import json
import os
import subprocess
import sys
import tempfile

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]
os.environ["OMP_NUM_THREADS"] = "1"

import torch

import test_torch_parallel as tp


def main(seeds):
    torch.set_num_threads(1)
    for seed in seeds:
        tp.SEED = seed
        model = tp.small_model()
        params = model.state_dict()
        batch = tp.small_batch(2)
        want = {"data": tp.one_process_step(params, batch),
                "space": tp.one_process_step(params, tp.first(batch))}
        with tempfile.TemporaryDirectory() as d:
            torch.save({"cfg": tp.CFG, "params": params, "batch": batch,
                        "seed": seed, "fine": want["space"][2], "trees": []},
                       f"{d}/inputs.pt")
            procs = [subprocess.Popen(
                [sys.executable, str(tp.WORKER), f"file://{d}/rendezvous",
                 "2", str(r), d], stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            for p in procs:
                _, err = p.communicate(timeout=tp.TIMEOUT)
                assert p.returncode == 0, err[-2000:]
            ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                     for r in range(2)]
        names = [n for n, _ in model.named_parameters()]
        for case in ("data", "space"):
            variance, other = {}, (0.0, None)
            for rank in ranks:
                for n, g, w in zip(names, rank[case]["grads"], want[case][1]):
                    scale = float(w.abs().max())
                    if scale < tp.GRAD_FLOOR:
                        continue
                    rel = float((g - w).abs().max()) / scale
                    if n.endswith(".variance"):
                        variance[n] = max(variance.get(n, 0.0), rel)
                    elif rel > other[0]:
                        other = (rel, n)
            print(json.dumps({"seed": seed, "case": case,
                              "variance": variance, "other_max": other}),
                  flush=True)


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1].split(",")])

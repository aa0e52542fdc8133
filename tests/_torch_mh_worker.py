"""Multi-process test worker of the port: one rank of a 2-process gloo
cluster on the CPU, 4 cells each (an 8-cell global mesh).  Launched by
tests/test_torch_multihost.py; results land in an npz that the parent holds
against single-process fleets of both packages.  It imports neither jax nor
the JAX package (the constants and clips come from tests/_mh_worker.py,
which imports jax only inside its main), and checks that before it exits.

Usage: python tests/_torch_mh_worker.py RANK NPROCS PORT OUTDIR
       [--checkpoint] [--ring] [--raw]

``--ring``: the ring-carry protocol (else the tail protocol); ``--raw``:
the ABSDIFF fleet; ``--checkpoint``: each rank saves its streams after
round 0 and a fresh engine resumes from the file.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tests._mh_worker import (BATCH, FRAMES_PER_RANK, H, ROUNDS,  # noqa: E402
                              S_GLOBAL, W, make_clip)

CELLS = 4


def main() -> int:
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    ring = "--ring" in sys.argv

    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    from dips_tpu_torch.parallel import (MultiHostStreamEngine,
                                         init_multihost, stream_mesh)
    from dips_tpu_torch.properties import (DiPsFilter, DiPsProperties,
                                           OutputMode)

    info = init_multihost(f"127.0.0.1:{port}", nprocs, rank)
    assert (info.process_index, info.process_count) == (rank, nprocs), info
    assert info.is_coordinator == (rank == 0)
    # documented idempotency: a second call reports the same topology
    assert init_multihost(f"127.0.0.1:{port}", nprocs, rank) == info

    if "--raw" in sys.argv:
        props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2)
    else:
        props = DiPsProperties(window_size=3, temporal_size=2,
                               filter=DiPsFilter.UNFILTERED)
    mesh = stream_mesh(devices=["cpu"] * CELLS)

    def engine():
        return MultiHostStreamEngine(props, H, W, S_GLOBAL, batch=BATCH,
                                     mesh=mesh, device="cpu",
                                     ring_carry=ring)

    eng = engine()
    assert eng.ring_carry is ring
    assert eng.local_stream_ids == list(range(rank * CELLS,
                                              (rank + 1) * CELLS))
    clips = {si: make_clip(n=FRAMES_PER_RANK[rank], h=H, w=W, seed=100 + si)
             for si in eng.local_stream_ids}
    outs, stats_all, gmeans, cursor = {}, {}, [], 0
    for rnd, plan in enumerate(ROUNDS):
        n_rnd = plan[rank]
        feed = eng.local_frames_template()
        for si in eng.local_stream_ids:
            feed[si] = list(clips[si][cursor:cursor + n_rnd])
        out, stats, gmean = eng.process_batch(feed)
        assert out.shape[:2] == (eng.n_local_streams, n_rnd), out.shape
        outs[rnd], stats_all[rnd] = out, stats
        gmeans.append(gmean)
        cursor += n_rnd
        if "--checkpoint" in sys.argv and rnd == 0:
            path = os.path.join(outdir, f"ckpt_{rank}.npz")
            eng.save(path)
            eng = engine()
            eng.load(path)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             local_stream_ids=np.asarray(eng.local_stream_ids),
             gmeans=np.asarray(gmeans),
             frame_cursors=np.asarray(
                 [eng.frame_cursors[i] for i in eng.local_stream_ids]),
             heatmaps=eng.heatmaps(),
             **{f"out{r}": outs[r] for r in outs},
             **{f"stats{r}": stats_all[r] for r in stats_all})
    dist.destroy_process_group()
    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "dips_tpu"))
    assert not loaded, loaded
    print(f"WORKER-{rank}-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker for the executed multi-process distributed test (r4 VERDICT #4).

Launched as 2 CPU processes (2 virtual devices each) by
tests/test_distributed_mp.py. Each process joins the cluster through
``distributed.init_distributed`` (the same entry a multi-host launch uses,
SURVEY.md §5 distributed backend), builds the cross-process
``distributed.global_mesh``, runs the row-sharded apply on a 4-device mesh
spanning both processes, and checks its addressable output shards against
the host golden. Success prints PARITY_OK.

Usage: mp_worker.py <coordinator_port> <process_id> <num_processes>
"""

import sys

import numpy as np


def main() -> int:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from jincresize_tpu.distributed import global_mesh, init_distributed

    init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_dev == nproc * n_local, (n_dev, n_local)

    mesh = global_mesh(n_rows=n_dev)
    assert mesh.devices.size == n_dev

    from jincresize_tpu.golden import apply_plane_numpy
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu.sharding import ShardedApplier

    op = build_plane_operator(64, 48, 128, 96, radius_for_tap(3))
    applier = ShardedApplier(op, mesh)
    print(f"# p{pid}: interior={applier.interior}", flush=True)

    # Deterministic source, identical on every process (fully-replicated
    # host input; jit shards it onto the global mesh).
    src = np.random.default_rng(7).random((48, 64), dtype=np.float32)
    out = applier(src, out_dtype=np.uint8, peak=255.0)
    jax.block_until_ready(out)
    ref = apply_plane_numpy(op, src, out_dtype=np.uint8, peak=255.0)

    # Cross-process output: compare only this process's addressable shards.
    n_checked = 0
    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        want = ref[shard.index]
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= 1, (shard.index, diff)
        n_checked += got.size
    assert n_checked > 0
    print(f"PARITY_OK p{pid} checked={n_checked}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Spawned gloo worlds for the parallel layer's CPU tests.

``run_world(world, "module:function", payload, tmp_dir)`` starts ``world``
processes (``torch.multiprocessing``, spawn), joins them into one gloo
process group through a ``FileStore`` under ``tmp_dir`` (so concurrent test
workers never share a port), calls ``function(mesh, payload)`` on every
rank with ``make_cells_mesh(device="cpu")`` and returns the ranks' results
(numpy trees) in rank order. The function lives at module level in a test
module that imports no jax at its top, so a rank never imports jax; the
JAX oracle runs in the parent. Each rank runs one thread, and the group's
own timeout makes a hung collective fail its test instead of the suite.
"""
import datetime
import importlib
import os
import traceback

TIMEOUT_S = 120


def _rank_main(rank, world, store_path, target, payload, queue):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
        from batchelor_torch.parallel import make_cells_mesh

        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        out = fn(make_cells_mesh(device="cpu"), payload)
        dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:                       # report, then let the parent fail
        queue.put((rank, "error", traceback.format_exc()))


def run_world(world: int, target: str, payload, tmp_dir) -> list:
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store_path = os.path.join(str(tmp_dir), f"store_{world}_{target.replace(':', '_')}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store_path, target, payload, queue),
                         daemon=True) for r in range(world)]
    results, errors = {}, []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(results) < world and not errors:
            try:
                rank, status, out = queue.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without reporting, or a world that hangs,
                # fails the test instead of waiting for it
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif time.monotonic() > deadline:
                    errors.append(f"the world of {world} did not finish in {TIMEOUT_S} s")
                continue
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=1 if errors else 10)
                if p.is_alive():
                    p.kill()
                    p.join()
        queue.cancel_join_thread()
        queue.close()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]

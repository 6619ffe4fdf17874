"""Rank worker of tests/test_torch_port_mesh.py (not collected: its name
does not start with ``test_``).

Each rank is a process started by ``torch.multiprocessing`` with the
``spawn`` method. It imports only torch, numpy and the port, never JAX: the
JAX side of the comparisons runs in the test process. A rank joins a gloo
process group through a ``FileStore``, builds the port's toy bundles on the
CPU, from numpy weights (the JAX toy bundles' parameters, handed over by
the test process and carried across by ``models/convert.py``) or from a
seed that differs from rank to rank (the weights every rank must take from
the first through ``put_replicated``), runs the jobs it
is given in order, every rank the same jobs, and writes what they return to
``rank{r}.pkl`` in the output directory. The group is destroyed when the
jobs end or fail; a failure raises, and ``torch.multiprocessing`` hands its
traceback to the test.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from elasticdiffusion_tpu_torch.configs import RuntimeConfig
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, unet_from_jax, vae_from_jax)
from elasticdiffusion_tpu_torch.models.registry import load_bundle

RUNTIME = RuntimeConfig(param_dtype=torch.float32, compute_dtype=torch.float32)


def build_bundle(spec, rank):
    """The port's toy bundle on the CPU: spec holds the port's bundle config
    and either the JAX parameter trees as numpy arrays or a seed, to which
    the rank is added."""
    tb = load_bundle(spec["config"].sd_version, RUNTIME,
                     bundle_config=spec["config"],
                     controlnet_model=spec.get("controlnet_model"),
                     device="cpu", seed=spec.get("seed", 0) + rank)
    if "unet" not in spec:
        return tb
    tb.unet.load_state_dict(unet_from_jax(spec["unet"]))
    tb.vae_fp32.load_state_dict(vae_from_jax(spec["vae"]))
    for model, params in zip(tb.text_models, spec["text"]):
        model.load_state_dict(clip_from_jax(params))
    return tb


def t2n(t):
    return t.detach().cpu().numpy()


def generate(job, bundles):
    """One generate_image on a mesh of job["mesh"]: per-step latents, the
    final latent and image, the UNet's batch rows per call on this rank
    and the collective inventory. job["inject"]: latents, scripted noise
    and the background tables to replay, as pipeline_parity_run injects
    them."""
    import elasticdiffusion_tpu_torch.core.background as tbg
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    from elasticdiffusion_tpu_torch.parallel.sharding import make_mesh
    tb = bundles[job["bundle"]]
    mesh = make_mesh(job["mesh"], device_type="cpu")
    pipe = ElasticDiffusion(bundle=tb, device="cpu", mesh=mesh,
                            view_batch_size=job.get("view_batch_size", 0))
    pipe.seed_everything(job.get("seed", 0))
    rows = []
    hook = tb.unet.register_forward_pre_hook(
        lambda m, args: rows.append(int(args[0].shape[0])))
    make_table = tbg.make_background_table
    tables = job.get("tables")
    if tables is not None:
        replay = iter(tables)
        tbg.make_background_table = lambda *a, **k: {
            s: torch.tensor(v) for s, v in next(replay).items()}
    try:
        img, info = pipe.generate_image(list(job["prompts"]),
                                        return_arrays=True, **job["kw"])
    finally:
        tbg.make_background_table = make_table
        hook.remove()
    return {"image": img, "latent": info["latent"],
            "step_latents": [t2n(l) for l in pipe.last_step_latents],
            "rows": rows, "collectives": pipe.last_metrics["collectives"],
            "views_width": job["mesh"][1]}


def halo(job, bundles):
    """halo_decode of job["latent"] on a mesh of job["mesh"], with the calls
    of the GroupNorm halves' dispatch recorded as mesh_norm_shapes lists
    them, and the collectives."""
    from elasticdiffusion_tpu_torch.parallel import halo_decode as thd
    from elasticdiffusion_tpu_torch.parallel.sharding import (
        collective_inventory, make_mesh, reset_collective_inventory)
    tb = bundles[job["bundle"]]
    mesh = make_mesh(job["mesh"], device_type="cpu")
    calls = []
    sums, apply = thd.moment_sums, thd.scale_shift
    thd.moment_sums = lambda x, mode: (
        calls.append(("sums", tuple(x.shape), False)), sums(x, mode))[1]
    thd.scale_shift = lambda x, a, b, silu, mode: (
        calls.append(("apply", tuple(x.shape), silu)),
        apply(x, a, b, silu, mode))[1]
    reset_collective_inventory()
    try:
        img = thd.halo_decode(tb, torch.from_numpy(job["latent"]), mesh=mesh)
    finally:
        thd.moment_sums, thd.scale_shift = sums, apply
    return {"image": t2n(img), "calls": calls,
            "collectives": collective_inventory()}


def cli(job, bundles):
    """The CLI's main() with job["argv"] (which holds --mesh) on the CPU at
    toy size: what it returns (the directory it wrote, None on a rank that
    writes nothing)."""
    import functools

    import elasticdiffusion_tpu_torch.apps.cli as tcli
    make_pipe = tcli.make_pipe
    tcli.make_pipe = functools.partial(make_pipe, device="cpu",
                                       bundle_config=job["config"])
    try:
        return {"save_dir": tcli.main(job["argv"])}
    finally:
        tcli.make_pipe = make_pipe


JOBS = {"generate": generate, "halo": halo, "cli": cli}


def run(rank, world, store_path, out_dir, specs, jobs):
    """The body of one rank: torch.multiprocessing.spawn's target."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        bundles = {name: build_bundle(spec, rank)
                   for name, spec in specs.items()}
        out = {job["name"]: JOBS[job["kind"]](job, bundles) for job in jobs}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world, tmp_dir, specs, jobs):
    """Run `jobs` on `world` ranks; the list of each rank's results."""
    import torch.multiprocessing as mp
    mp.spawn(run, args=(world, os.path.join(tmp_dir, "store"), tmp_dir,
                        specs, jobs), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def same_everywhere(results, name, key) -> bool:
    """Whether every rank's result[name][key] is bitwise rank 0's."""
    first = np.asarray(results[0][name][key])
    return all(np.array_equal(np.asarray(r[name][key]), first)
               for r in results[1:])

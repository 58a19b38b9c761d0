"""End-to-end training launcher, ported from the JAX package's
``repro/launch/train.py``: every architecture, the encoder-decoder and
vision models with random frame and patch embeddings drawn from the
step's seed, as the reference draws them.

Two modes:

* ``--mode dp``  — training of an assigned architecture (smoke or full
  config) on the synthetic token stream, AdamW, one device.
* ``--mode hfl`` — the paper's schedule on top of the same model: an
  ('edge', 'ue') mesh of local-SGD replicas, one UE a ``torch.distributed``
  rank (``launch.mesh.run_ranks``), params averaged within the edge every
  ``a`` steps and over the fleet every ``a*b``, with (a, b) chosen by the
  paper's optimizer from the delay model.

Both train through ``impl="xla_flash"``, the reference's route (the CUDA
kernels have no backward).  Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10
      # full-width StableLM-1.6B on the card (26.3 GB of params and AdamW)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --smoke --steps 10 --device cpu      # the loss adds the MoE aux loss
  PYTHONPATH=src python -m repro_torch.launch.train --mode hfl --edges 2 \\
      --ues 2 --smoke --rounds 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
      --steps 10     # full width on the card: 128 frames, 16 tokens a row
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.problem import HFLProblem
from repro_torch.core.schedule import plan
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_map

#: Bound on a ``--mode hfl`` run's ranks (collectives and the whole spawn).
RANK_TIMEOUT_S = 3600.0


def batch_for(model, stream, b, s, step):
    """A ``(b, s)`` batch of ``stream`` on the model's device.  As in the
    reference, the token stream's batch does not depend on ``step``; an
    encoder-decoder takes ``s`` frames and the first ``s //
    decoder_len_ratio`` tokens and targets, a vision model
    ``num_prefix_embeds`` patches and the first ``s - num_prefix_embeds``,
    the frames and patches normals from ``default_rng(step)``."""
    cfg = model.cfg
    d = stream.batch(b, s)
    if cfg.encoder_decoder:
        st = s // cfg.decoder_len_ratio
        rng = np.random.default_rng(step)
        d = {"frames": rng.normal(0, 1, (b, s, cfg.d_model)).astype(
                 np.float32),
             "tokens": d["tokens"][:, :st], "targets": d["targets"][:, :st]}
    elif cfg.frontend == "vision":
        P = cfg.num_prefix_embeds
        rng = np.random.default_rng(step)
        d = {"patches": rng.normal(0, 1, (b, P, cfg.d_model)).astype(
                 np.float32),
             "tokens": d["tokens"][:, :s - P],
             "targets": d["targets"][:, :s - P]}
    return {k: torch.as_tensor(v, device=model.device) for k, v in d.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_dp(args) -> dict:
    """``--mode dp``.  Returns the final params and optimizer state, the
    loss of every step and the seconds of every step (each ended by
    reading its loss)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, impl="xla_flash", device=args.device)
    stream = TokenStream(cfg.vocab_size, seed=0)
    params = model.init(args.seed)
    n_params = model.num_params()
    print(f"arch={args.arch} smoke={args.smoke} params={n_params/1e6:.1f}M")
    optimizer = adamw(args.lr)
    opt_state = optimizer.init(params)
    step_fn = steps_lib.make_train_step(model, optimizer)
    losses, step_s = [], []
    _sync(model.device)
    t0 = t_step = time.perf_counter()
    for i in range(args.steps):
        batch = batch_for(model, stream, args.batch, args.seq, i)
        params, opt_state, mets = step_fn(params, opt_state, batch)
        loss = float(mets["loss"])
        now = time.perf_counter()
        losses.append(loss)
        step_s.append(now - t_step)
        t_step = now
        if (i + 1) % args.log_every == 0 or i == 0:
            dt = (now - t0) / (i + 1)
            print(f"step {i+1:5d}  loss {loss:8.4f}  {dt*1e3:8.1f} ms/step")
            assert np.isfinite(loss), "loss diverged"
    print(f"done: {args.steps} steps in {time.perf_counter()-t0:.1f}s")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_s": step_s}


def hfl_rounds(args, sch, mesh, rounds: int):
    """``--mode hfl`` on this rank of an ('edge', 'ue') mesh
    (``launch.mesh.make_fl_mesh``): ``rounds`` cloud rounds of
    ``fl.spmd.make_hfl_cloud_round`` over ``model.loss``.  Every rank of
    the mesh must run it together.  Yields ``(round, sim_clock, loss,
    params)`` after each cloud event: the loss of the rank's params on its
    batch, and its params (unstacked, the mesh's device)."""
    from repro_torch.fl.spmd import make_hfl_cloud_round, stack_for_mesh
    cfg = get_config(args.arch, smoke=args.smoke)
    # remat=False: the local steps run the loss under torch.func's vmap of
    # grad, which takes no torch.utils.checkpoint (saved-tensor hooks);
    # remat changes memory only
    model = build_model(cfg, impl="xla_flash", remat=False,
                        device=mesh.device)
    stream = TokenStream(cfg.vocab_size, seed=0)
    E, U = mesh.num_edges, mesh.ues_per_edge
    cloud_round = make_hfl_cloud_round(model.loss, mesh, a=sch.a, b=sch.b,
                                       lr=args.lr)
    params = mesh.local(stack_for_mesh(model.init(args.seed), E, U))
    weights = np.asarray(sch.problem.samples[:E * U], np.float32)
    clock = 0.0
    for r in range(rounds):
        batch = batch_for(model, stream, args.batch, args.seq, r)
        stacked = {k: v[None].expand((E * U,) + tuple(v.shape))
                   for k, v in batch.items()}
        params = cloud_round(params, mesh.local(stacked),
                             mesh.local(weights))
        clock += sch.cloud_round_time
        one = tree_map(lambda t: t[0], params)
        with torch.no_grad():
            loss = float(model.loss(one, batch)[0])
        yield r, clock, loss, one


def _hfl_rank(args, sch, rounds: int) -> dict:
    """One rank of ``run_hfl`` (``run_ranks`` spawns it)."""
    from repro_torch.launch.mesh import make_fl_mesh
    if torch.device(args.device or "cuda").type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (args.edges * args.ues)))
    mesh = make_fl_mesh(args.edges, args.ues, device=args.device,
                        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    losses, params = [], None
    for r, clock, loss, params in hfl_rounds(args, sch, mesh, rounds):
        if mesh.rank == 0:
            print(f"cloud round {r+1}/{rounds}  sim-time {clock:8.2f}s  "
                  f"loss {loss:.4f}", flush=True)
        assert np.isfinite(loss)
        losses.append(loss)
    return {"rank": mesh.rank, "losses": losses,
            "params": tree_map(lambda t: t.detach().cpu(), params)}


def run_hfl(args) -> dict:
    """``--mode hfl``: the paper's 3-layer schedule over local-SGD
    transformer replicas, ``edges * ues`` spawned ranks (gloo; on the card
    they share it).  Returns the schedule and every rank's losses and
    final params (CPU tensors), in rank order."""
    from repro_torch.launch.mesh import run_ranks
    E, U = args.edges, args.ues
    # (a, b) from the paper's optimizer over a synthetic wireless problem
    prob = HFLProblem(num_edges=E, num_ues=E * U, epsilon=args.epsilon,
                      seed=args.seed)
    sch = plan(prob)
    print(f"HFL schedule: a={sch.a} b={sch.b} R={sch.rounds} "
          f"T={sch.cloud_round_time:.3f}s (delay model)")
    rounds = args.rounds or min(sch.rounds, 5)
    ranks = run_ranks(_hfl_rank, E * U, args, sch, rounds,
                      device=args.device, timeout_s=RANK_TIMEOUT_S)
    return {"schedule": sch, "ranks": ranks}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--mode", default="dp", choices=["dp", "hfl"])
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--ues", type=int, default=2, help="UEs per edge")
    ap.add_argument("--epsilon", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "hfl":
        return run_hfl(args)
    return run_dp(args)


if __name__ == "__main__":
    main()

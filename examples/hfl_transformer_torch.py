"""HFL local-SGD over a transformer on a mesh of ranks (end to end): the
PyTorch port's twin of ``examples/hfl_transformer.py``.

The paper's schedule as a feature of the transformer substrate: E x U
``torch.distributed`` ranks (gloo; on one card, or on the CPU) form an
('edge', 'ue') mesh; the optimal (a, b) come from the roofline bridge
(``plan_from_roofline``, on the H100's NVLink and InfiniBand rates unless
``--edge-bw`` and ``--cloud-bw`` say otherwise); every rank trains its own
replica of a reduced StableLM with parameter averaging at the paper's sync
points.

Run:  python examples/hfl_transformer_torch.py               (the card)
      python examples/hfl_transformer_torch.py --edges 2 --ues-per-edge 2 \\
          --rounds 1 --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import schedule as sched_lib  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.spmd import make_hfl_cloud_round, stack_for_mesh  # noqa: E402
from repro_torch.launch.mesh import (IB_BW, NVLINK_BW, make_fl_mesh,  # noqa: E402
                                     run_ranks)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.optimizers import tree_map  # noqa: E402

ARCH = "stablelm-1.6b"
# The reference's hand-written dry-run roofline terms and model size.
ROOFLINE = {"compute_s": 0.012, "memory_s": 0.24, "collective_s": 1.34}
MODEL_BYTES = 3.2e9
SEQS_PER_UE, SEQ_LEN, LR = 2, 128, 5e-3
TIMEOUT_S = 900.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--ues-per-edge", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks (cuda or cpu)")
    ap.add_argument("--edge-bw", type=float, default=NVLINK_BW,
                    help="UE -> edge link, bytes/s (default: NVLink 4)")
    ap.add_argument("--cloud-bw", type=float, default=IB_BW,
                    help="edge -> cloud link, bytes/s (default: NDR IB)")
    return ap.parse_args(argv)


def schedule(args):
    """(a, b) from the roofline terms on ``args``' mesh and links."""
    return sched_lib.plan_from_roofline(
        ROOFLINE, num_edges=args.edges, ues_per_edge=args.ues_per_edge,
        model_bytes=MODEL_BYTES, ici_bw=args.edge_bw, dcn_bw=args.cloud_bw)


def plan_line(sch) -> str:
    return (f"plan_from_roofline: a={sch.a} b={sch.b} R={sch.rounds} "
            f"cloud-round T={sch.cloud_round_time:.2f}s")


def rank_main(args, a: int, b: int) -> dict:
    """One UE's rank: ``args.rounds`` cloud rounds of its replica; its loss
    on its own batch after each, and its final params (on the CPU)."""
    E, U = args.edges, args.ues_per_edge
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (E * U)))
    mesh = make_fl_mesh(E, U, device=args.device)
    cfg = get_config(ARCH, smoke=True)
    # remat=False: the local steps take torch.func's vmap of grad, which
    # runs no torch.utils.checkpoint
    model = build_model(cfg, impl="xla_flash", remat=False,
                        device=mesh.device)
    stream = TokenStream(cfg.vocab_size, seed=0)
    cloud_round = make_hfl_cloud_round(model.loss, mesh, a=a, b=b, lr=LR)
    params = mesh.local(stack_for_mesh(model.init(0), E, U))
    weights = mesh.local(np.ones((E * U,), np.float32))
    losses = []
    for r in range(args.rounds):
        bt = stream.batch(E * U * SEQS_PER_UE, SEQ_LEN, step=r)
        batch = mesh.local({k: v.reshape(E * U, SEQS_PER_UE, SEQ_LEN)
                            for k, v in bt.items()})
        params = cloud_round(params, batch, weights)
        with torch.no_grad():
            loss, _ = model.loss(tree_map(lambda t: t[0], params),
                                 {k: v[0] for k, v in batch.items()})
        losses.append(float(loss))
    return {"losses": losses,
            "params": tree_map(lambda t: t[0].detach().cpu(), params)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    E, U = args.edges, args.ues_per_edge
    sch = schedule(args)
    print(plan_line(sch))
    print("mesh:", {"edge": E, "ue": U})
    ranks = run_ranks(rank_main, E * U, args, sch.a, sch.b,
                      device=args.device, timeout_s=TIMEOUT_S)
    for r, loss in enumerate(ranks[0]["losses"]):
        print(f"cloud round {r+1}: loss {loss:.4f} "
              f"(simulated {sch.cloud_round_time*(r+1):.1f}s)")
    first, last = ranks[0]["params"], ranks[-1]["params"]
    agreement = float((first["embedding"] - last["embedding"]).abs().max())
    print("replica agreement after cloud round:", agreement)
    return {"schedule": sch, "ranks": ranks, "agreement": agreement,
            "equal": all(torch.equal(x, y) for rank in ranks[1:]
                         for x, y in zip(tree_leaves(first),
                                         tree_leaves(rank["params"])))}


if __name__ == "__main__":
    main()

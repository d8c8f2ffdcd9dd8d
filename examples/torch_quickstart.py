"""Quickstart on the PyTorch port: the NeuroVectorizer loop in miniature
(paper Fig. 3), driven entirely through the ``repro_torch.api`` facade.

Extract kernel sites from a model -> fit the PPO bandit on a synthetic
corpus -> tune the sites -> inject the tile program -> check that the tuned
Hopper kernel computes the same numbers.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --steps 500                         # the kernels' plain versions

The modelled speedup is the cost model's (its TPU v5e time formula under
the Hopper kernels' launch rule), not an H100 number.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.api import (NeuroVecConfig, NeuroVectorizer,  # noqa: E402
                             extract_arch_sites)
from repro_torch.core import dataset  # noqa: E402
from repro_torch.models import compute  # noqa: E402
from repro_torch.models.compute import KernelSite  # noqa: E402

# max |tuned - eager| over max |eager| for the bf16 demo matmul: both round
# an f32-accumulated sum of 256 products to bf16 (2^-8 relative), in
# different summation orders
DEMO_TOL = 2e-2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=5000,
                    help="PPO training steps")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = NeuroVecConfig(train_batch=500, sgd_minibatch=125, ppo_epochs=6)
    nv = NeuroVectorizer(cfg, agent="ppo", lr=5e-4, seed=0,
                         device=args.device)

    print("== 1. extract kernel sites (the 'loop extractor') ==")
    sites = extract_arch_sites("qwen3_8b", batch=8, seq=2048)
    for s in sites[:5]:
        print("  ", s.key())
    print(f"  ... {len(sites)} sites total")

    print("== 2. fit the deep-RL agent on a synthetic corpus ==")
    corpus = dataset.generate(1500, seed=0, base=sites)
    nv.fit(corpus, total_steps=args.steps)
    hist = nv.agent.history
    print(f"  reward mean: {hist[0]['reward_mean']:+.3f} -> "
          f"{hist[-1]['reward_mean']:+.3f}  (positive = beats baseline)")

    print("== 3. tune the extracted sites (inference mode) ==")
    prog = nv.tune_sites(sites)
    sp = nv.speedup(prog, sites)
    print(f"  modelled speedup over heuristic baseline: {sp:.2f}x "
          f"(cost model, not a measurement)")

    print("== 4. inject: same math through the tuned kernel ==")
    dev = nv.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((128, 256), generator=gen, device=dev).bfloat16()
    w = torch.randn((256, 512), generator=gen, device=dev).bfloat16()
    site = KernelSite(site="demo", kind="matmul", m=128, n=512, k=256,
                      dtype="bfloat16")
    demo_prog = nv.tune_sites([site])
    y_ref = compute.matmul(x, w, site="demo")
    with nv.inject(demo_prog):
        y_tuned = compute.matmul(x, w, site="demo")
    rel = float((y_tuned.float() - y_ref.float()).abs().max()
                / y_ref.float().abs().max())
    print(f"  tiles={demo_prog.tiles[site.key()]}  max |diff| / max |y| = "
          f"{rel:.2e} (tol {DEMO_TOL})")
    nv.close()
    if not rel < DEMO_TOL:
        raise AssertionError(f"tuned matmul differs from eager: {rel:.3e}")
    print("quickstart OK")
    return {"sites": len(sites), "speedup": sp, "rel_err": rel,
            "tiles": demo_prog.tiles[site.key()],
            "reward_first": hist[0]["reward_mean"],
            "reward_last": hist[-1]["reward_mean"]}


if __name__ == "__main__":
    main()

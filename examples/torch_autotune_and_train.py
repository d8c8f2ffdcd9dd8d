"""End-to-end driver on the PyTorch port: tune an LM's kernel tiles
through the ``repro_torch.api`` facade, save the program, then train the
LM with ``repro_torch.launch.train`` (checkpoints and a restart-safe data
stream) and check that the loss falls; the counterpart of
``examples/autotune_and_train.py``.

    PYTHONPATH=src python examples/torch_autotune_and_train.py      # card
    PYTHONPATH=src python examples/torch_autotune_and_train.py \\
        --device cpu --rl-steps 500 --steps 30

Training is eager, as in the reference: no kernel has a backward (nor
has any Pallas kernel of the reference), so the saved program serves and
measures the model, and ``launch.train --tune`` with it raises at the
first step.  The modelled speedup is the cost model's (its TPU v5e time
formula under the Hopper kernels' launch rule), not an H100 number.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.api import (NeuroVecConfig, NeuroVectorizer,  # noqa: E402
                             extract_arch_sites)
from repro_torch.core import dataset  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--agent", default="ppo",
                    help="any repro_torch.api registry name (ppo, brute, ...)")
    ap.add_argument("--rl-steps", type=int, default=4000)
    ap.add_argument("--out-dir", default="",
                    help="where the program and checkpoints go (default: a "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out_dir or tmp
        print("== tune ==")
        cfg = NeuroVecConfig(train_batch=500, sgd_minibatch=125, ppo_epochs=6)
        nv = NeuroVectorizer(cfg, agent=args.agent, seed=0,
                             device=args.device,
                             **({"lr": 5e-4} if args.agent == "ppo" else {}))
        sites = extract_arch_sites(args.arch, batch=8, seq=2048)
        fit_kw = ({"total_steps": args.rl_steps} if args.agent == "ppo"
                  else {})
        nv.fit(dataset.generate(1200, seed=0, base=sites), **fit_kw)
        prog = nv.tune_sites(sites)
        tiles = os.path.join(out, "tiles.json")
        prog.save(tiles)
        sp = nv.speedup(prog, sites)
        nv.close()
        print(f"saved TileProgram with {len(prog.tiles)} sites to {tiles} "
              f"(modelled speedup {sp:.2f}x)")

        print("== train (eager) + checkpoint/restart ==")
        losses = train_mod.main([
            "--arch", args.arch, "--steps", str(args.steps), "--batch", "8",
            "--seq", "64", "--lr", "1e-3", "--ckpt-dir",
            os.path.join(out, "ckpt"), "--ckpt-every", "50",
            "--device", args.device])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}")
    print(f"e2e OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    return {"sites": len(prog.tiles), "speedup": sp, "losses": losses}


if __name__ == "__main__":
    main()

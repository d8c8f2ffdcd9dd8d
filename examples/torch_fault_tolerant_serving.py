"""Serving with the production substrate on the PyTorch port: batched
KV-cache decode, straggler monitoring, an elastic re-plan after a
simulated chip failure, and a NeuroVectorizer tile plan for the serving
kernels through the ``repro_torch.api`` facade.

    PYTHONPATH=src python examples/torch_fault_tolerant_serving.py \\
        [--device cpu] [--full]

The plan is brute force over the prefill step's sites.  On the card it is
injected, so the prefill and the decode steps run the Hopper kernels (K1,
in bf16 and at the MoE routers in f32, and K2) at the planned tiles; the
injected prefill's logits are printed against an eager prefill's.
Without ``--full`` the model is Jamba's reduced config; with it, Jamba
v0.1 at its published widths and 8 of its 32 layers (one period), which
needs the card.  It prints ``OK`` at the end.
"""
import argparse
import contextlib
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

ARCH = "jamba_v0_1_52b"
FULL_LAYERS = 8                  # one period of Jamba's 32 layers


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the plan injected) or cpu")
    ap.add_argument("--full", action="store_true",
                    help=f"{ARCH} at its published widths, {FULL_LAYERS} "
                         f"layers (default: its reduced config)")
    ap.add_argument("--legality", default=None,
                    choices=("tpu_v5e", "h100", "cpu"),
                    help="the plan's legality profile (default: the serve "
                         "driver's, h100 on the card, cpu on the CPU)")
    ap.add_argument("--inject", action="store_true",
                    help="inject the plan on the CPU too (the plain "
                         "versions); on the card it always is")
    ap.add_argument("--save-tiles", default=None,
                    help="write the tile plan (a TileProgram) here")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)    # no card: raise before any work

    from repro_torch.api import NeuroVectorizer, extract_sites
    from repro_torch.configs import get_config
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.env import CostModelEnv
    from repro_torch.ft.monitor import StepMonitor, plan_elastic_mesh
    from repro_torch.launch.serve import legality_for
    from repro_torch.models.lm import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=FULL_LAYERS) if args.full \
        else cfg.reduced()
    model = build_model(cfg)
    B, prompt, gen = 4, 16, 12
    ctx = prompt + gen
    params = model.init(seed=0, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(device)}
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    print(f"== tile plan for the serving step (repro_torch.api facade; "
          f"{cfg.name}, {cfg.n_layers} layers) ==")
    meta_prompts = torch.empty((B, prompt), dtype=torch.long, device="meta")
    sites = extract_sites(prefill, model.init(device="meta"),
                          {"tokens": meta_prompts},
                          model.make_cache(B, ctx, device="meta"))
    legality = args.legality or legality_for(device)
    nv = NeuroVectorizer(agent="brute",         # exhaustive: few serve sites
                         oracle=CostModelEnv(DEFAULT, legality=legality),
                         device=device)
    prog = nv.fit(sites).tune_sites(sites)
    if args.save_tiles:
        prog.save(args.save_tiles)
    inject = device.type == "cuda" or args.inject
    print(f"  {len(prog.tiles)} sites tuned under legality={legality}; "
          f"modelled speedup {nv.speedup(prog, sites):.2f}x (TPU-v5e cost "
          f"model, not a measurement; "
          f"{'injected' if inject else 'eager'})")

    out = {"prog": prog, "sites": sites, "legality": legality,
           "injected": inject, "layers": cfg.n_layers}
    with torch.inference_mode():
        eager_logits = None
        if inject:
            eager_logits, _ = prefill(params, batch,
                                      model.make_cache(B, ctx, device=device))
        with (nv.inject(prog) if inject else contextlib.nullcontext()):
            if inject:      # untimed: loads the kernel variants the plan
                prefill(params, batch,   # names
                        model.make_cache(B, ctx, device=device))
            cache = model.make_cache(B, ctx, device=device)
            print("== batched decode with straggler monitoring ==")
            sync()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch, cache)
            sync()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            mon = StepMonitor(warmup=3, z_thresh=3.0)
            tok = logits.argmax(-1)[:, None]
            seq = [tok]
            for i in range(gen - 1):
                mon.start()
                tok, _, cache = serve(params, tok, prompt + i, cache)
                sync()
                ev = mon.stop(i)
                if ev:
                    print(f"  straggler flagged at step {i}: z={ev['z']:.1f}")
                seq.append(tok)
    nv.close()
    out.update(logits=logits, eager_logits=eager_logits,
               tokens=torch.cat(seq, 1), decode_step_ms=mon.mean * 1e3,
               straggler_events=len(mon.events))
    if not torch.isfinite(logits).all() or \
            out["tokens"].shape != (B, gen):
        raise SystemExit(f"bad serve output: logits finite "
                         f"{bool(torch.isfinite(logits).all())}, tokens "
                         f"{tuple(out['tokens'].shape)}")
    print(f"  decoded {gen} tokens/request; prefill {out['prefill_ms']:.1f} "
          f"ms; mean step {out['decode_step_ms']:.1f} ms; "
          f"{out['straggler_events']} straggler events")
    if eager_logits is not None:
        out["logits_rel"] = float((logits - eager_logits).abs().max()
                                  / eager_logits.abs().max())
        print(f"  injected vs eager prefill logits: max |difference| over "
              f"max |eager logit| {out['logits_rel']:.4e}")

    print("== elastic re-plan after simulated failures ==")
    out["replans"] = []
    for healthy in (256, 248, 192, 130):
        p = plan_elastic_mesh(healthy_chips=healthy, model_parallel=16,
                              global_batch=128)
        line = (f"  {healthy:4d} healthy chips -> mesh {p.mesh_shape}, "
                f"drop {p.dropped_chips}, global_batch {p.global_batch}")
        out["replans"].append(line)
        print(line)
    print("serving example OK")
    return out


if __name__ == "__main__":
    main()

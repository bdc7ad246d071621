"""End-to-end driver of the port: train HAN at 8 heads × 128 (2.2 M
parameters) for a few hundred steps on synthetic ACM with
checkpoint/resume.

    PYTHONPATH=src python examples_torch/train_hgnn_han.py [--steps 300]      # on the card
    PYTHONPATH=src python examples_torch/train_hgnn_han.py --device cpu --steps 3 \\
        --scale 0.05 --ckpt artifacts/han_ckpt_cpu --no-resume

Checkpoints go to ``--ckpt`` (default ``artifacts/han_ckpt`` under the
working directory); a run resumes from the newest one there unless
``--no-resume`` is given.

A thin veneer over the training launcher (``repro_torch.launch.hgnn_train``):
the model is widened (hidden 128 × 8 heads, att_dim 256, ACM's full
1,902-wide features), trained full-batch (transductive node classification, as HAN
trains) through the multi-lane NA path at B = 128 — one launch of kernel
#1 over the plan's units a step and one of #2 in the backward, at the
widest row those kernels take (8 × 128 = 1,024 floats) — with the
fault-tolerant train_loop: atomic checkpoints, counter-based data state.
"""
import argparse

from repro_torch.launch.hgnn_train import run_training


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument(
        "--backend", default="kernel",
        choices=("reference", "kernel", "kernel_interpret"),
    )
    ap.add_argument("--ckpt", default="artifacts/han_ckpt")
    ap.add_argument("--no-resume", action="store_true",
                    help="start from step 0 even if --ckpt holds a checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    state, history, meta = run_training(
        dataset="acm",
        model_name="HAN",
        steps=args.steps,
        backend=args.backend,
        hidden=128,
        heads=8,
        scale=args.scale,
        feat_scale=1.0,
        ckpt_dir=args.ckpt,
        ckpt_every=100,
        resume=not args.no_resume,
        log_every=20,
        device=args.device,
    )
    if not history:
        print(f"{args.ckpt} already holds {args.steps} steps: nothing to train "
              f"(--no-resume starts again)")
        return state, history, meta
    print(
        f"training complete: loss {history[0]['loss']:.4f} -> "
        f"{history[-1]['loss']:.4f}  acc {history[-1]['acc']:.3f}  "
        f"({meta['n_params']/1e6:.1f}M params, backend={meta['backend']})"
    )
    return state, history, meta


if __name__ == "__main__":
    main()

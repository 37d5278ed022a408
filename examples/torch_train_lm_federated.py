"""End-to-end driver on the port: DRACO-train an assigned-architecture
LM through `repro_torch.launch.train.main` (the counterpart of
`examples/train_lm_federated.py`).

Default: a reduced qwen2-family model, 4 clients, 200 steps: the full
production path (model zoo -> DRACO step -> the gossip-mix kernel ->
unification -> checkpointing). Checkpoints go to a fresh temporary
directory, so a second run starts from step 0 again. Runs on CUDA;
``--device cpu`` on purpose.

For a ~100M-parameter run on the card:
  python examples/torch_train_lm_federated.py --hundred-m --steps 300 --clients 8

  PYTHONPATH=src python examples/torch_train_lm_federated.py
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M-param config (needs the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="accepted and ignored: the reduced config is already the "
                         "default unless --hundred-m")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="repro_torch_lm_ckpt_") as tmp:
        argv = [
            "--arch", args.arch, "--steps", str(args.steps),
            "--clients", str(args.clients), "--seq", str(args.seq),
            "--batch-per-client", "2", "--mix", "dense", "--psi", "2",
            "--unify-every", "50", "--ckpt-dir", tmp,
            "--ckpt-every", "100", "--log-every", "20",
        ]
        if args.device is not None:
            argv += ["--device", args.device]
        if not args.hundred_m:
            argv.append("--reduced")
        losses = train_main(argv)
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} DRACO windows")
    return losses


if __name__ == "__main__":
    main()

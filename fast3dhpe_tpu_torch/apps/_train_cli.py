"""The flags both training CLIs share (fast3dhpe_tpu/apps/train.py and
train_cdr.py), and the call into a loop through run_with_retries."""

from __future__ import annotations

import argparse

from ..config import load_config
from ..train.resilience import run_with_retries


def parse_and_run(run_fn, default_config: str, description: str,
                  argv=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config_path", type=str, default=default_config,
                        help="Path to the config file")
    parser.add_argument("--overwrite", action="store_true",
                        help="Replace an existing weights/<NAME> dir "
                             "(the reference prompts interactively)")
    parser.add_argument("--weights_root", type=str, default="weights")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; an error without a card) or "
                             "cpu")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (fp32 params, Adam state "
                             "and BN statistics)")
    parser.add_argument("--plot_dir", type=str, default=None,
                        help="write loss curves here after training")
    parser.add_argument("--resume", action="store_true",
                        help="continue from weights/<NAME>/latest.pth and "
                             "latest.opt.pt")
    parser.add_argument("--log_every", type=int, default=None,
                        help="log per-step loss/grad-norm/lr + live "
                             "throughput every N steps")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 1-4 "
                             "here")
    parser.add_argument("--retries", type=int, default=0,
                        help="resume from the last checkpoint after a "
                             "retryable failure (train/resilience.py), up "
                             "to N times")
    parser.add_argument("--checkpoint_every", type=int, default=1,
                        help="save the rolling latest checkpoint every N "
                             "epochs")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="write checkpoints on a background thread")
    parser.add_argument("--no_segments", action="store_true",
                        help="accepted for the JAX package's command "
                             "lines; the port runs no segments")
    parser.add_argument("--per_batch", action="store_true",
                        help="iterate the loader batch by batch even when "
                             "the device cache holds the dataset")
    parser.add_argument("--segment_epochs", type=int, default=None,
                        help="accepted for the JAX package's command "
                             "lines; the port runs no segments")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    return run_with_retries(
        run_fn, config, retries=args.retries, overwrite=args.overwrite,
        weights_root=args.weights_root, seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        plot_dir=args.plot_dir, resume=args.resume,
        log_every=args.log_every, trace_dir=args.trace_dir,
        scan_epochs=False if args.per_batch else None,
        segments=False if (args.no_segments or args.per_batch) else None,
        checkpoint_every=args.checkpoint_every,
        segment_epochs=args.segment_epochs,
        async_checkpoint=args.async_checkpoint, device=args.device)

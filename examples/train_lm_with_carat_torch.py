"""End-to-end example of the PyTorch port: train a (reduced) LM with the
PFS-backed input pipeline, comparing CARAT off and on (the twin of
``examples/train_lm_with_carat.py``).

    PYTHONPATH=src python examples/train_lm_with_carat_torch.py \
        [--steps 120] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-root", default=tempfile.gettempdir(),
                    help="directory that holds the two runs' checkpoints")
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--steps", str(args.steps),
              "--hosts", "4", "--sample-kb", "2048", "--device", args.device]
    print("=== run 1: CARAT input-pipeline co-tuning DISABLED ===")
    off = train_main(common + ["--no-carat", "--ckpt-dir",
                               os.path.join(args.ckpt_root, "ck_off")])
    print("\n=== run 2: CARAT input-pipeline co-tuning ENABLED ===")
    on = train_main(common + ["--ckpt-dir",
                              os.path.join(args.ckpt_root, "ck_on")])
    print("\nCompare the input_wait_s and pfs_MBps lines: CARAT tunes each "
          "host's PFS client online while training runs.")
    return off, on


if __name__ == "__main__":
    main()

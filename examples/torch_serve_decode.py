"""Batched serving example on the PyTorch port: greedy decode with a KV
cache on a reduced gemma3 (5-local:1-global sliding-window pattern)
through ``repro_torch.launch.serve``. The port of
examples/serve_decode.py; runs on the card unless ``--device cpu`` is
asked for.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main(["--arch", "gemma3-27b", "--batch", "2",
                       "--prompt-len", "24", "--gen", "12",
                       "--device", args.device])


if __name__ == "__main__":
    main()

"""Command line of the PyTorch port: ``generate`` and ``edit``.

    python -m p2p_tpu_torch edit --preset sd14 --mode replace \\
        --source "a cat riding a bicycle" --target "a dog riding a bicycle" \\
        --steps 50 --seeds 8191 --kernels --out-dir out/

Weights are random (from fixed seeds) and prompts go through the hash-word
tokenizer: loading a checkpoint needs the CLIP BPE tokenizer, which is not
ported yet. Runs on CUDA unless ``--device cpu`` is given. The JAX CLI's
flags this slice does not support are rejected with a message, never
ignored.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

import numpy as np

# JAX CLI flags the port does not support yet, with what they need.
_UNSUPPORTED = {
    "batch_seeds": ("--batch-seeds", "the batched sweep engine"),
    "gate": ("--gate", "phase-gated sampling"),
    "schedule": ("--schedule", "reuse schedules"),
    "blend_words": ("--blend-words", "LocalBlend"),
    "equalizer": ("--equalizer", "Reweight"),
    "attn_maps": ("--attn-maps", "attention-map visualization"),
    "checkpoint": ("--checkpoint", "the CLIP BPE tokenizer"),
}


def _reject_unsupported(args) -> None:
    for attr, (flag, what) in _UNSUPPORTED.items():
        value = getattr(args, attr, None)
        if value not in (None, False):
            raise SystemExit(f"{flag} is not supported by p2p_tpu_torch yet "
                             f"(needs {what}, a later slice of the port)")


def _build_pipeline(args):
    from .engine.sampler import random_pipeline
    from .models.config import PRESET_CONFIGS
    from .utils.tokenizer import HashWordTokenizer

    cfg = PRESET_CONFIGS[args.preset]
    tok = HashWordTokenizer(model_max_length=cfg.text.max_length)
    return random_pipeline(cfg, tok, args.device)


def _save(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)


def _generator(pipe, seed: int):
    import torch

    return torch.Generator(pipe.device).manual_seed(seed)


def _kernels(args):
    from .kernels.dispatch import KernelConfig

    return KernelConfig() if args.kernels else None


def cmd_generate(args) -> int:
    from .engine.sampler import text2image

    _reject_unsupported(args)
    pipe = _build_pipeline(args)
    for seed in args.seeds:
        img, _, _ = text2image(pipe, [args.prompt], None, num_steps=args.steps,
                               guidance_scale=args.guidance,
                               generator=_generator(pipe, seed),
                               negative_prompt=args.negative_prompt,
                               device=pipe.device)
        path = args.out
        if len(args.seeds) > 1:
            root, ext = os.path.splitext(args.out)
            path = f"{root}_{seed:05d}{ext}"
        _save(img[0].cpu().numpy(), path)
        if not args.quiet:
            print(f"seed {seed}: {path}")
    return 0


def cmd_edit(args) -> int:
    from .controllers.factory import make_controller
    from .engine.sampler import text2image

    _reject_unsupported(args)
    pipe = _build_pipeline(args)
    prompts = [args.source, args.target]
    controller = make_controller(
        prompts, is_replace_controller=args.mode == "replace",
        cross_replace_steps=args.cross_steps,
        self_replace_steps=args.self_steps, tokenizer=pipe.tokenizer,
        num_steps=args.steps)
    out_dir = args.out_dir or os.path.join("logs", time.strftime("%y%m%d_%H%M%S"))
    for seed in args.seeds:
        common = dict(num_steps=args.steps, guidance_scale=args.guidance,
                      negative_prompt=args.negative_prompt, device=pipe.device)
        base, x_t, _ = text2image(pipe, prompts, None,
                                  generator=_generator(pipe, seed), **common)
        img, _, _ = text2image(pipe, prompts, controller, latent=x_t,
                               kernels=_kernels(args), **common)
        _save(base[0].cpu().numpy(), os.path.join(out_dir, f"{seed:05d}_y.jpg"))
        _save(img[1].cpu().numpy(), os.path.join(out_dir, f"{seed:05d}_y_hat.jpg"))
        if not args.quiet:
            print(f"seed {seed}: {out_dir}/{seed:05d}_y.jpg, "
                  f"{out_dir}/{seed:05d}_y_hat.jpg")
    return 0


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2p_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", choices=("tiny", "sd14"), default="tiny")
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' must be "
                             "asked for)")
        sp.add_argument("--guidance", type=float, default=7.5)
        sp.add_argument("--steps", type=int, default=50)
        sp.add_argument("--scheduler", choices=("ddim",), default="ddim",
                        help="only DDIM is ported")
        sp.add_argument("--seeds", type=_int_list, default=[8191],
                        help="comma-separated seed sweep")
        sp.add_argument("--negative-prompt", default=None)
        sp.add_argument("--quiet", action="store_true")
        # Accepted only to be rejected with a message (see _UNSUPPORTED).
        sp.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
        sp.add_argument("--batch-seeds", action="store_true", help=argparse.SUPPRESS)
        sp.add_argument("--gate", default=None, help=argparse.SUPPRESS)
        sp.add_argument("--schedule", default=None, help=argparse.SUPPRESS)

    g = sub.add_parser("generate", help="text-to-image, no editing")
    common(g)
    g.add_argument("--prompt", required=True)
    g.add_argument("--out", default="outputs/image.png")
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("edit", help="prompt-to-prompt edit with seed sweep")
    common(e)
    e.add_argument("--source", required=True, help="source prompt")
    e.add_argument("--target", required=True, help="edited prompt")
    e.add_argument("--out-dir", default=None)
    e.add_argument("--mode", choices=("replace", "refine"), default="refine")
    e.add_argument("--cross-steps", type=float, default=0.8)
    e.add_argument("--self-steps", type=float, default=0.4)
    e.add_argument("--kernels", action="store_true",
                   help="run the edited sites through the fused-edit kernel")
    e.add_argument("--blend-words", default=None, help=argparse.SUPPRESS)
    e.add_argument("--equalizer", default=None, help=argparse.SUPPRESS)
    e.add_argument("--attn-maps", default=None, help=argparse.SUPPRESS)
    e.set_defaults(fn=cmd_edit)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

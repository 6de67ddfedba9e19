"""Command line of the PyTorch port: ``generate``, ``edit``, ``invert`` and
``replay``.

    python -m p2p_tpu_torch edit --preset sd14 --mode replace \\
        --source "a cat riding a bicycle" --target "a dog riding a bicycle" \\
        --steps 50 --seeds 8191 --kernels --out-dir out/
    python -m p2p_tpu_torch edit --preset sd21 ...  (SD-2.1 768-v; sd21base 512)
    python -m p2p_tpu_torch edit --preset ldm256 ...  (LDM-256: LDMBert, VQ-f8)
    python -m p2p_tpu_torch edit --preset sd14 --scheduler plms ...  (or dpm)
    python -m p2p_tpu_torch invert --preset sd14 --image cat.png \\
        --prompt "a cat riding a bicycle" --artifact out/inversion.npz
    python -m p2p_tpu_torch replay --preset sd14 --artifact out/inversion.npz \\
        --mode replace --target "a dog riding a bicycle" --blend-words cat,dog \\
        --equalizer dog=2 --kernels --out-dir out/
    python -m p2p_tpu_torch invert --preset sd21 ...  (768² image, v-prediction)
    python -m p2p_tpu_torch replay --preset sd21 ... --blend-resolution 24

Weights are random (from fixed seeds) and prompts go through the hash-word
tokenizer, its ids within the text encoder's vocabulary (30522 at LDM):
loading a checkpoint needs the CLIP BPE tokenizer, which is not ported
yet. Runs on CUDA unless ``--device cpu`` is given. The JAX CLI's flags
this slice does not support are rejected with a message, never ignored; so
are ``invert`` and ``replay`` at the LDM presets, where the JAX package
runs no null-text inversion, and on a config whose inversion would need K4
at a head dim it has no kernel for (every SD preset has them).

LocalBlend reads the cross maps stored at ``--blend-resolution``, a
quarter of the latent side: the default 16 at SD-1.4 and 512-base (64²
latent), 24 at SD-2.1 768-v (96² latent), where maps are stored at 48²,
24² and 12² and the default 16 raises.
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
    "batch_targets": ("--batch-targets", "the batched sweep engine"),
    "gate": ("--gate", "phase-gated sampling"),
    "schedule": ("--schedule", "reuse schedules"),
    "attn_maps": ("--attn-maps", "attention-map visualization"),
    "checkpoint": ("--checkpoint", "the CLIP BPE tokenizer"),
}


def _reject_unsupported(args) -> None:
    for attr, (flag, what) in _UNSUPPORTED.items():
        value = getattr(args, attr, None)
        if value not in (None, False):
            raise SystemExit(f"{flag} is not supported by p2p_tpu_torch yet "
                             f"(needs {what}, a later slice of the port)")


# Presets without null-text inversion: the JAX package runs none at LDM.
_NO_INVERSION = ("ldm256", "tiny_ldm")


def _reject_inversion(args) -> None:
    from .engine.inversion import require_k4
    from .models.config import PRESET_CONFIGS

    if args.preset in _NO_INVERSION:
        raise SystemExit(f"{args.cmd} --preset {args.preset} is not supported: "
                         "the JAX package runs no null-text inversion at LDM")
    require_k4(PRESET_CONFIGS[args.preset], f"{args.cmd} --preset {args.preset}")


def _build_pipeline(args):
    from .engine.sampler import random_pipeline
    from .models.config import PRESET_CONFIGS
    from .utils.tokenizer import HashWordTokenizer

    cfg = PRESET_CONFIGS[args.preset]
    tok = HashWordTokenizer(vocab_size=cfg.text.vocab_size,
                            model_max_length=cfg.text.max_length)
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


def _parse_equalizer(spec):
    """``"word=scale,..."`` → ``{"words": (...), "values": (...)}``."""
    if not spec:
        return None
    words, values = [], []
    for part in spec.split(","):
        w, v = part.split("=")
        words.append(w.strip())
        values.append(float(v))
    return {"words": tuple(words), "values": tuple(values)}


def _make_controller(args, prompts, tokenizer, num_steps):
    """The controller of ``edit`` and ``replay``, assembled as the JAX
    CLI's ``controller_from_opts`` does: ``--blend-words`` ("cat,dog")
    selects the same words in every prompt."""
    from .controllers.factory import make_controller

    blend = args.blend_words.split(",") if args.blend_words else None
    return make_controller(
        prompts, is_replace_controller=args.mode == "replace",
        cross_replace_steps=args.cross_steps,
        self_replace_steps=args.self_steps, tokenizer=tokenizer,
        num_steps=num_steps,
        blend_words=None if blend is None else [blend] * len(prompts),
        equalizer_params=_parse_equalizer(args.equalizer),
        blend_resolution=args.blend_resolution)


def cmd_generate(args) -> int:
    from .engine.sampler import text2image

    _reject_unsupported(args)
    pipe = _build_pipeline(args)
    for seed in args.seeds:
        img, _, _ = text2image(pipe, [args.prompt], None, num_steps=args.steps,
                               guidance_scale=args.guidance,
                               scheduler=args.scheduler,
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
    from .engine.sampler import text2image

    _reject_unsupported(args)
    pipe = _build_pipeline(args)
    prompts = [args.source, args.target]
    controller = _make_controller(args, prompts, pipe.tokenizer, args.steps)
    out_dir = args.out_dir or os.path.join("logs", time.strftime("%y%m%d_%H%M%S"))
    for seed in args.seeds:
        common = dict(num_steps=args.steps, guidance_scale=args.guidance,
                      scheduler=args.scheduler,
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


def cmd_invert(args) -> int:
    from .engine.inversion import invert, load_image

    _reject_unsupported(args)
    _reject_inversion(args)
    pipe = _build_pipeline(args)
    image = load_image(args.image, size=pipe.config.image_size)
    art = invert(pipe, image, args.prompt, num_steps=args.steps,
                 guidance_scale=args.guidance,
                 num_inner_steps=args.inner_steps, device=pipe.device)
    os.makedirs(os.path.dirname(args.artifact) or ".", exist_ok=True)
    art.save(args.artifact)
    print(f"wrote {args.artifact}")
    if not args.quiet:
        print(f"inner steps per outer step: {art.inner_steps}")
    if args.out_dir:
        _save(art.image_gt, os.path.join(args.out_dir, "gt.png"))
        _save(art.image_rec, os.path.join(args.out_dir, "vae_rec.png"))
    return 0


def cmd_replay(args) -> int:
    import torch

    from .engine.inversion import InversionArtifact
    from .engine.sampler import text2image

    _reject_unsupported(args)
    _reject_inversion(args)
    targets = args.target or []
    pipe = _build_pipeline(args)
    art = InversionArtifact.load(args.artifact)
    out_dir = args.out_dir or "outputs"
    x_t = torch.from_numpy(art.x_t)
    ups = torch.from_numpy(art.uncond_embeddings)
    for i, target in enumerate(targets or [None]):
        prompts = [art.prompt, target] if target else [art.prompt]
        controller = (None if target is None else _make_controller(
            args, prompts, pipe.tokenizer, art.num_steps))
        img, _, _ = text2image(pipe, prompts, controller,
                               num_steps=art.num_steps,
                               guidance_scale=args.guidance, latent=x_t,
                               uncond_embeddings=ups, kernels=_kernels(args),
                               device=pipe.device)
        if i == 0:
            _save(img[0].cpu().numpy(), os.path.join(out_dir, "reconstruction.png"))
        if target is not None:
            name = "edited.png" if len(targets) == 1 else f"edited_{i:02d}.png"
            _save(img[1].cpu().numpy(), os.path.join(out_dir, name))
        if not args.quiet:
            print(f"replay {target!r}: {out_dir}")
    return 0


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2p_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def model_opts(sp):
        sp.add_argument("--preset", choices=("tiny", "sd14", "sd21", "sd21base",
                                             "ldm256", "tiny_ldm"),
                        default="tiny")
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' must be "
                             "asked for)")
        sp.add_argument("--guidance", type=float, default=7.5)
        sp.add_argument("--quiet", action="store_true")
        # Accepted only to be rejected with a message (see _UNSUPPORTED).
        sp.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)

    def edit_opts(sp):
        sp.add_argument("--mode", choices=("replace", "refine"), default="refine")
        sp.add_argument("--cross-steps", type=float, default=0.8)
        sp.add_argument("--self-steps", type=float, default=0.4)
        sp.add_argument("--blend-words", default=None,
                        help="comma-separated words for LocalBlend masking")
        sp.add_argument("--equalizer", default=None,
                        help="word=scale[,word=scale...] reweighting")
        sp.add_argument("--blend-resolution", type=int, default=16,
                        help="side of the cross maps LocalBlend reads: 16 at "
                             "512² (sd14, sd21base) and 256² (ldm256), 24 at "
                             "768² (sd21)")
        sp.add_argument("--kernels", action="store_true",
                        help="run the edited sites through the fused-edit kernel")
        sp.add_argument("--attn-maps", default=None, help=argparse.SUPPRESS)

    def common(sp):
        model_opts(sp)
        sp.add_argument("--steps", type=int, default=50)
        sp.add_argument("--scheduler", choices=("ddim", "plms", "dpm"),
                        default="ddim")
        sp.add_argument("--seeds", type=_int_list, default=[8191],
                        help="comma-separated seed sweep")
        sp.add_argument("--negative-prompt", default=None)
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
    edit_opts(e)
    e.add_argument("--source", required=True, help="source prompt")
    e.add_argument("--target", required=True, help="edited prompt")
    e.add_argument("--out-dir", default=None)
    e.set_defaults(fn=cmd_edit)

    # Inversion is DDIM by construction: no --scheduler or --seeds here.
    i = sub.add_parser("invert", help="null-text inversion of a real image")
    model_opts(i)
    i.add_argument("--steps", type=int, default=50)
    i.add_argument("--image", required=True)
    i.add_argument("--prompt", required=True)
    i.add_argument("--artifact", default="outputs/inversion.npz")
    i.add_argument("--inner-steps", type=int, default=10)
    i.add_argument("--out-dir", default=None,
                   help="also write gt.png / vae_rec.png here")
    i.set_defaults(fn=cmd_invert)

    # Replay takes its step count from the artifact.
    r = sub.add_parser("replay", help="edit a previously inverted image")
    model_opts(r)
    edit_opts(r)
    r.add_argument("--artifact", required=True)
    r.add_argument("--target", action="append", default=None,
                   help="edited prompt; repeatable for a target sweep "
                        "(omit for pure reconstruction)")
    r.add_argument("--out-dir", default=None)
    r.add_argument("--batch-targets", action="store_true", help=argparse.SUPPRESS)
    r.set_defaults(fn=cmd_replay)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

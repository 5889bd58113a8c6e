"""Per-level seg maps and a prompt's CLIP similarity maps of preprocessed
2D language features, a check on preprocessing before training (port of
scripts/inspect_features.py; reference inspect_features.py):

    python -m langsplatv2_tpu_torch.tools.inspect_features \\
        --lf_path <scene>/language_features --image_name frame_00001 \\
        --prompt "teddy bear"

The prompt is encoded on the device; a level's similarity is each
assigned pixel's feature row dotted with the unit text embedding, 0 where
no segment lies (the script's numpy arithmetic). The 2x4 figure (seg
maps under "tab20", similarities under "jet") is written only when
matplotlib imports (the card's machine has none). The flags are the
script's, plus `--device` (default "cuda"); --clip_backend defaults to
"hash", as the port's other tools do. `main(argv)` returns the arrays.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from ..eval.openclip import OpenCLIPNetwork


def inspect(lf_path: str, image_name: str, prompt: str = "object",
            clip_backend: str = "hash", device=None) -> dict:
    """seg [4, H, W], feats [N, 512], text [1, 512] (unit), sims [4, H, W]."""
    seg = np.load(os.path.join(lf_path, image_name + "_s.npy"))
    feats = np.load(os.path.join(lf_path, image_name + "_f.npy"))
    clip = OpenCLIPNetwork(backend=clip_backend, device=device)
    text = clip.encode_text([prompt]).cpu().numpy()
    text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    sims = []
    for lvl in range(4):
        sim = np.zeros(seg[lvl].shape, np.float32)
        valid = seg[lvl] >= 0
        sim[valid] = (feats[seg[lvl][valid]] @ text[0])
        sims.append(sim)
    return dict(seg=seg, feats=feats, text=text, sims=np.stack(sims))


def save_figure(res: dict, prompt: str, output: str) -> bool:
    """The script's figure; False (nothing written) without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(20, 10))
    for lvl in range(4):
        plt.subplot(2, 4, lvl + 1)
        plt.title(f"seg level {lvl}")
        plt.imshow(res["seg"][lvl], cmap="tab20")
        plt.axis("off")
        plt.subplot(2, 4, 4 + lvl + 1)
        plt.title(f"sim '{prompt}' level {lvl}")
        plt.imshow(res["sims"][lvl], cmap="jet")
        plt.colorbar()
        plt.axis("off")
    plt.savefig(output, bbox_inches="tight")
    plt.close()
    return True


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--lf_path", type=str, required=True)
    parser.add_argument("--image_name", type=str, required=True,
                        help="basename without _s/_f suffix")
    parser.add_argument("--prompt", type=str, default="object")
    parser.add_argument("--output", type=str, default="inspect_result.png")
    parser.add_argument("--clip_backend", type=str, default="hash")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    res = inspect(args.lf_path, args.image_name, args.prompt,
                  args.clip_backend, args.device)
    seg, feats = res["seg"], res["feats"]
    print(f"seg {seg.shape} ids [{seg.min()}, {seg.max()}], "
          f"features {feats.shape}")
    res["figure"] = save_figure(res, args.prompt, args.output)
    print(f"saved {args.output}" if res["figure"]
          else "matplotlib is not installed; no figure written")
    return res


if __name__ == "__main__":
    main()

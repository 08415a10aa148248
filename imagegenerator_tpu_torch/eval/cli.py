"""Evaluation CLI: CLIPScore and the CLIP-Fréchet distance of sample sets
— counterpart of ``imagegenerator_tpu/eval/cli.py``, with its flags and
its JSON line.

    # caption fidelity of generated samples (CLIPScore)
    python -m imagegenerator_tpu_torch.eval.cli --samples samples/ \\
        --captions "a red bus|a dog" --clip_checkpoint ViT-B-32.pt \\
        --bpe_vocab bpe_simple_vocab_16e6.txt.gz

    # distribution distance against a real set (CLIP-FID)
    python -m imagegenerator_tpu_torch.eval.cli --samples samples/ \\
        --ref real_images/ --clip_checkpoint ViT-B-32.pt

    # every batch split over two ranks, a card each
    torchrun --standalone --nproc_per_node 2 -m imagegenerator_tpu_torch.eval.cli \\
        --dp 2 --samples samples/ --ref real_images/ --clip_checkpoint RN50.pt -m RN50

Inputs are a directory of PNG or JPEG files, a single image file, or an
``.npz`` with an ``images`` array (N, H, W, 3), uint8 or [0, 1] float,
read member by member. One streaming pass over the samples feeds both
metrics, and nothing larger than a batch is held. In a directory, an
image of another size than the first is resized to it with Pillow's
bicubic; without Pillow, PNGs are read by ``utils/png.py`` and mixed
sizes raise. Captions are ``|``-separated, or ``@path`` for one per
line; one caption is broadcast to every sample, and each distinct
caption is embedded once. Without ``--clip_checkpoint`` the tower is
the v2 CLI's randomly initialised tiny model (the numbers then show
only that the pipeline runs, and the JSON line says ``tiny-random``).

Runs on the card unless ``--device cpu``. ``--dp N`` runs under
``torchrun --nproc_per_node N``: each rank embeds its share of every
batch, and the float64 Fréchet moments, the score sums and the counts
are summed over the ranks before rank 0 prints the line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from imagegenerator_tpu_torch.data import coco
from imagegenerator_tpu_torch.eval import clip_eval, frechet
from imagegenerator_tpu_torch.parallel import dp
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.v2.clip import CLIP
from imagegenerator_tpu_torch.v2.engine import frozen
from imagegenerator_tpu_torch.v2.generate import load_clip
from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer

MODULE = "imagegenerator_tpu_torch.eval.cli"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m {MODULE}", description=__doc__.split("\n")[0])
    p.add_argument("--samples", required=True, help="generated set: image directory or .npz")
    p.add_argument("--ref", default=None, help="real/reference set (enables the Fréchet metric)")
    p.add_argument("--captions", default=None,
                   help="'|'-separated captions aligned with --samples (or @file, one per line; "
                        "a single caption broadcasts) — enables CLIPScore")
    p.add_argument("-m", "--clip_model", default="ViT-B/32",
                   help="CLIP tower name (the v2 CLI's -m choices)")
    p.add_argument("--clip_checkpoint", default=None, help="OpenAI CLIP checkpoint (.pt, a state_dict)")
    p.add_argument("--bpe_vocab", default=None,
                   help="CLIP BPE vocab (v2 --bpe_vocab); hash fallback when absent")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dp", type=int, default=1,
                   help="split each embedding batch over this many ranks (torchrun "
                        "--nproc_per_node N; --batch must divide evenly)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default=None, help="also write the JSON result to this path")
    p.add_argument("--device", default=None,
                   help="cuda (default; fails without a card), cuda:N or cpu; under torchrun "
                        "the default is a card per rank")
    return p


class ImageSet:
    """A lazy image source: a directory of images, one image file, or an
    ``.npz`` with an ``images`` array. ``batches(b)`` yields [0, 1]
    float32 chunks of at most ``b`` images without holding the whole set
    (an ``.npz`` member is read sequentially, never loaded whole)."""

    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, path: str):
        self.path = path
        self._size = None  # a directory's first image's (width, height)
        if path.endswith(".npz"):
            shape, _ = self._npz_header()  # the member's header only
            if len(shape) != 4 or shape[-1] != 3:
                raise ValueError(f"{path}: expected (N, H, W, 3), got {shape}")
            self._names = None
            self._n = shape[0]
        elif os.path.isfile(path):
            self._names = [path]
            self._n = 1
        else:
            self._names = [os.path.join(path, f) for f in sorted(os.listdir(path))
                           if f.lower().endswith(self._EXTS)]
            if not self._names:
                raise ValueError(f"no images found in {path}")
            self._n = len(self._names)

    def __len__(self) -> int:
        return self._n

    def _decode(self, path: str) -> np.ndarray:
        """RGB uint8, at the first image's size (every rank holds its
        share to image 0's)."""
        Image = coco._pillow()
        if Image is None:
            with open(path, "rb") as f:
                arr = coco._decode_png(f.read())
            if self._size is None:
                first = arr if path == self._names[0] else self._decode(self._names[0])
                self._size = first.shape[1::-1]
            if arr.shape[1::-1] != self._size:
                raise ValueError(f"{path} is {arr.shape[1]}x{arr.shape[0]}, the set's first image "
                                 f"{self._size[0]}x{self._size[1]}: mixed sizes are resized with "
                                 "Pillow, which is not installed")
            return arr
        if self._size is None:
            with Image.open(self._names[0]) as first:  # the header only
                self._size = first.size
        with Image.open(path) as im:
            im = im.convert("RGB")
            if im.size != self._size:
                # mixed sizes: conform to the first image; the tower's input
                # is resized to its resolution regardless
                im = im.resize(self._size, Image.BICUBIC)
            return np.asarray(im, np.uint8)

    def _npz_member(self):
        """The ``images`` member opened for sequential reading past its
        header: ``(member, zip file, shape, dtype)``. Works on compressed
        and stored members alike."""
        import zipfile

        from numpy.lib import format as npformat

        zf = zipfile.ZipFile(self.path)
        member = next((n for n in ("images.npy", "images") if n in zf.namelist()), None)
        if member is None:
            zf.close()
            raise ValueError(f"{self.path} has no 'images' array")
        f = zf.open(member)
        try:
            version = npformat.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = npformat.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = npformat.read_array_header_2_0(f)
            if fortran:
                raise ValueError(f"{self.path}: Fortran-order array unsupported")
        except Exception:
            f.close()
            zf.close()
            raise
        return f, zf, shape, dtype

    def _npz_header(self):
        f, zf, shape, dtype = self._npz_member()
        f.close()
        zf.close()
        return shape, dtype

    def batches(self, batch_size: int, share: tuple[int, int] = (0, 1)):
        """Per batch of ``batch_size`` images: ``(indices, images)``, this
        rank's rows of it (``share=(rank, world)``: contiguous, as even as
        they fall) as [0, 1] float32 ``(n, H, W, 3)`` and their positions
        in the set. A rank whose share of the last, ragged batch is empty
        gets no tuple for it."""
        rank, world = share
        npz = self._npz_member() if self._names is None else None
        try:
            for s in range(0, self._n, batch_size):
                n = min(batch_size, self._n - s)
                own = np.array_split(np.arange(s, s + n), world)[rank]
                if npz is not None:
                    f, _, shape, dtype = npz
                    buf = f.read(n * int(np.prod(shape[1:])) * dtype.itemsize)
                    chunk = np.frombuffer(buf, dtype=dtype).reshape((n,) + tuple(shape[1:]))[own - s]
                    if chunk.dtype == np.uint8:
                        chunk = chunk.astype(np.float32) / 255.0
                    images = np.asarray(chunk, np.float32)
                elif len(own):
                    images = np.stack([self._decode(self._names[i]) for i in own]).astype(np.float32) / 255.0
                if len(own):
                    yield own, images
        finally:
            if npz is not None:
                npz[0].close()
                npz[1].close()


def load_image_set(path: str) -> np.ndarray:
    """The whole set as one (N, H, W, 3) float32 [0, 1] array, for small
    sets and tests; the CLI itself streams ``ImageSet.batches``."""
    return np.concatenate([images for _, images in ImageSet(path).batches(64)], axis=0)


def parse_captions(spec: str, n_samples: int) -> list:
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            caps = [ln.strip() for ln in f if ln.strip()]
    else:
        caps = [c.strip() for c in spec.split("|") if c.strip()]
    if len(caps) == 1:
        caps = caps * n_samples
    if len(caps) != n_samples:
        raise ValueError(f"{len(caps)} captions for {n_samples} samples (give 1 to broadcast)")
    return caps


def _summed(moments: frechet.FeatureMoments) -> frechet.FeatureMoments:
    """``moments`` with its count and sums added over the ranks."""
    count, moments.sum, moments.outer = dp.all_reduce_sum(moments.count, moments.sum, moments.outer)
    moments.count = int(count)
    return moments


def main(argv=None):
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.ref is None and args.captions is None:
        parser.error("nothing to compute: give --ref, --captions, or both")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dp != world:
        if world == 1:
            parser.error(f"--dp {args.dp} runs one process per rank; start it as torchrun --standalone "
                         f"--nproc_per_node {args.dp} -m {MODULE} --dp {args.dp} ...")
        parser.error(f"--dp {args.dp}, but torchrun started {world} ranks (WORLD_SIZE); they must be equal")
    if args.batch % args.dp:
        parser.error(f"--batch {args.batch} does not divide over --dp {args.dp} ranks")
    samples = ImageSet(args.samples)
    ref = ImageSet(args.ref) if args.ref is not None else None
    if ref is not None:
        for flag, images in (("--samples", samples), ("--ref", ref)):
            if len(images) < 2:
                parser.error(f"the Fréchet distance needs at least 2 images in each set; {flag} "
                             f"{images.path} has {len(images)}")
    device = dp.init_from_env(args.device) if world > 1 else entry_device(args.device)
    try:
        return _evaluate(args, samples, ref, device)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _evaluate(args, samples: ImageSet, ref: ImageSet | None, device) -> dict:
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    cfg, state = load_clip(args.clip_model, args.clip_checkpoint)
    model = frozen(CLIP, cfg, state, dtype, device=device,
                   generator=torch.Generator(device=device).manual_seed(args.seed))
    real_weights = state is not None
    result = {
        "n_samples": len(samples),
        "clip_model": args.clip_model if real_weights else "tiny-random",
        "real_weights": real_weights,
    }
    share = (dp.rank(), dp.world())

    # captions: each distinct caption tokenized and embedded once
    te_n = idx = None
    if args.captions is not None:
        caps = parse_captions(args.captions, len(samples))
        unique = list(dict.fromkeys(caps))
        tokenizer = open_tokenizer(args.bpe_vocab, cfg.context_length, cfg.vocab_size)
        te = clip_eval.text_embeddings(model, tokenizer(unique), batch_size=args.batch).astype(np.float64)
        te_n = te / np.linalg.norm(te, axis=-1, keepdims=True)
        cap_row = {c: i for i, c in enumerate(unique)}
        idx = np.asarray([cap_row[c] for c in caps])

    # one streaming pass over the samples: each of this rank's rows is
    # embedded once and feeds both metrics
    moments = frechet.FeatureMoments(cfg.embed_dim) if ref is not None else None
    score_sum = 0.0
    for rows, images in samples.batches(args.batch, share):
        emb = clip_eval.image_embeddings(model, images, batch_size=args.batch)
        if moments is not None:
            moments.update(emb)
        if te_n is not None:
            ie = np.asarray(emb, np.float64)
            ie /= np.linalg.norm(ie, axis=-1, keepdims=True)
            score_sum += np.maximum((ie * te_n[idx[rows]]).sum(axis=-1), 0.0).sum()
    if te_n is not None:
        (score_sum,) = dp.all_reduce_sum(score_sum)
        result["clip_score"] = round(100.0 * float(score_sum) / len(samples), 4)

    if ref is not None:
        ref_moments = frechet.FeatureMoments(cfg.embed_dim)
        for _, images in ref.batches(args.batch, share):
            ref_moments.update(clip_eval.image_embeddings(model, images, batch_size=args.batch))
        result["n_ref"] = len(ref)
        distance = frechet.frechet_distance(*_summed(moments).stats(), *_summed(ref_moments).stats())
        result["frechet_clip_distance"] = round(distance, 6)

    if dp.is_main():
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()

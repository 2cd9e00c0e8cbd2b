"""Offline multiview feature pipeline of the PyTorch + CUDA port
(pointnet2_scannet_tpu_torch): the port's counterpart of scripts/multiview.py.

One command covering the reference's three offline stages: a scene's RGB
frames go through the ENet encoder in batches on --device, every frame's
point -> pixel correspondence is computed there, the 128-d features are
fused onto the points first-writer-wins (most-covering frame first), and all
scenes go into one HDF5 file keyed by scene id, the file --use_multiview
training reads (scripts/train_torch.py --multiview_h5).

Frame layout (ScanNet's frames_square export):
  <frames_root>/<scene_id>/color/<fid>.jpg   (RGB)
  <frames_root>/<scene_id>/depth/<fid>.png   (16-bit depth, millimetres)
  <frames_root>/<scene_id>/pose/<fid>.txt    (4 x 4 camera-to-world)

    python scripts/multiview_torch.py --frames_root F --scene_list L \
        [--data_dir data/preprocessed_scenes] [--enet_path data/scannetv2_enet.pth] \
        [--output data/enet_feats.hdf5] [--batch_size 64] [--skip_existing] [--device cuda]

Reading frames needs imageio and PIL, writing the file h5py; process_frames
(frames already in memory -> fused features) needs neither.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
from collections.abc import Iterable

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

COLOR_DIMS = (328, 256)  # (W, H) ENet input
DEPTH_DIMS = (41, 32)  # (W, H) feature / depth resolution


def resize_crop(image: np.ndarray, dims: tuple[int, int], nearest: bool) -> np.ndarray:
    """Resize keeping the aspect ratio to dims' height, then crop dims'
    width from the centre, as the reference's loader does."""
    from PIL import Image

    w, h = image.shape[1], image.shape[0]
    if (w, h) == dims:
        return image
    resize_w = int(math.floor(dims[1] * float(w) / float(h)))
    img = Image.fromarray(image).resize((resize_w, dims[1]), Image.NEAREST if nearest else Image.BILINEAR)
    left = (resize_w - dims[0]) // 2
    return np.array(img.crop((left, 0, left + dims[0], dims[1])))


def load_frame(scene_dir: pathlib.Path, fid: str):
    """(colour (H, W, 3) normalised for ENet, depth (32, 41) in metres,
    pose (4, 4)), float32."""
    import imageio.v2 as imageio

    from pointnet2_scannet_tpu_torch.models.enet import normalize_frame

    color = resize_crop(imageio.imread(scene_dir / "color" / f"{fid}.jpg"), COLOR_DIMS, nearest=True)
    color = normalize_frame(color.astype(np.float32) / 255.0).astype(np.float32)
    depth = imageio.imread(scene_dir / "depth" / f"{fid}.png")
    depth = resize_crop(depth, DEPTH_DIMS, nearest=True).astype(np.float32) / 1000.0
    pose = np.loadtxt(scene_dir / "pose" / f"{fid}.txt").astype(np.float32)
    return color, depth, pose


def process_frames(points: np.ndarray, batches: Iterable, encoder, device, cam=None):
    """Fused (N, 128) float32 features of one scene from its frames in
    memory: batches yields (colors (B, H, W, 3), depths (B, h, w), poses (B,
    4, 4)) numpy stacks; encoder is an eval-mode ENetEncoder on device. The
    features, correspondences and fusion stay on device; the fused features
    come back as numpy."""
    import torch

    from pointnet2_scannet_tpu_torch.data import multiview as mv

    cam = cam or mv.CameraConfig()
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    feats, valids, pixes = [], [], []
    with torch.inference_mode():
        for colors, depths, poses in batches:
            feats.append(encoder(torch.as_tensor(colors, device=device)))
            v, p = mv.compute_correspondence_batch(pts, depths, poses, cam)
            valids.append(v)
            pixes.append(p)
        if not feats:
            raise ValueError("no frames")
        fused = mv.fuse_scene_features(torch.cat(feats), torch.cat(valids), torch.cat(pixes))
    return fused.cpu().numpy()


def process_scene(scene_id, frames_root, points, encoder, batch_size, cam=None, device="cuda"):
    """process_frames over the scene's frames on disk, batch_size at a time."""
    scene_dir = pathlib.Path(frames_root) / scene_id
    fids = sorted(p.stem for p in (scene_dir / "color").glob("*.jpg"))
    if not fids:
        raise FileNotFoundError(f"no frames for {scene_id} under {scene_dir}")

    def batches():
        for start in range(0, len(fids), batch_size):
            frames = [load_frame(scene_dir, f) for f in fids[start:start + batch_size]]
            yield tuple(np.stack(parts) for parts in zip(*frames))

    return process_frames(points, batches(), encoder, device, cam)


def load_encoder(enet_path, device):
    """The eval-mode ENetEncoder of a reference ENet checkpoint, on device."""
    import torch

    from pointnet2_scannet_tpu_torch.models.enet import ENetEncoder, load_torch_enet_weights

    sd = load_torch_enet_weights(enet_path)
    encoder = ENetEncoder()
    encoder.load_state_dict({k[len("encoder."):]: torch.from_numpy(v) for k, v in sd.items()
                             if k.startswith("encoder.")}, strict=True)
    return encoder.to(device).eval()


def main(args) -> None:
    import h5py
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available (use --device cpu)")
    import pointnet2_scannet_tpu_torch  # noqa: F401  (switches TF32 off)

    scene_ids = [line.strip() for line in open(args.scene_list) if line.strip()]
    encoder = load_encoder(args.enet_path, device)
    with h5py.File(args.output, "a") as f:
        for scene_id in scene_ids:
            if scene_id in f:
                if args.skip_existing:
                    print(f"{scene_id}: exists, skipping")
                    continue
                del f[scene_id]
            points = np.load(pathlib.Path(args.data_dir) / f"{scene_id}.npy")[:, :3]
            fused = process_scene(scene_id, args.frames_root, points, encoder, args.batch_size,
                                  device=device)
            covered = float((np.abs(fused).sum(1) > 0).mean())
            f.create_dataset(scene_id, data=fused, compression="gzip")
            print(f"{scene_id}: {fused.shape} features, {covered:.1%} points covered")
    print(f"wrote {args.output}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames_root", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="data/preprocessed_scenes")
    p.add_argument("--scene_list", type=str, required=True)
    p.add_argument("--enet_path", type=str, default="data/scannetv2_enet.pth")
    p.add_argument("--output", type=str, default="data/enet_feats.hdf5")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())

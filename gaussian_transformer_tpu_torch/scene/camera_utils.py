"""Camera loading helpers: resolution logic (port of
``gaussian_transformer_tpu/scene/camera_utils.py``).

Same policy as the reference: -1 downscales images wider than 1600 px to
1600, 1/2/4/8 divide the resolution, any other value is a target width.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_transformer_tpu_torch.scene.cameras import Camera

_warned = False


def image_to_array(image: np.ndarray, resolution) -> np.ndarray:
    """uint8 [H, W, C] -> float32 CHW in [0, 1] at ``resolution`` (w, h).

    Same size: an exact conversion. Otherwise an antialiased bicubic resize
    (torch's PIL-style filter; close to, not bit-equal with, Pillow's)."""
    w, h = resolution
    arr = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1).float()
    if (h, w) != tuple(arr.shape[1:]):
        arr = F.interpolate(
            arr[None], size=(h, w), mode="bicubic", align_corners=False, antialias=True
        )[0].round().clamp(0, 255)
    return arr.numpy() / 255.0


def load_cam(args, id, cam_info, resolution_scale, device=None) -> Camera:
    if cam_info.image is None:
        # Image file missing: geometry-only camera.
        return Camera.create(
            colmap_id=cam_info.uid,
            R=cam_info.R,
            T=cam_info.T,
            fovx=cam_info.FovX,
            fovy=cam_info.FovY,
            image=None,
            gt_alpha_mask=None,
            image_name=cam_info.image_name,
            uid=id,
            width=cam_info.width,
            height=cam_info.height,
            device=device,
        )

    orig_h, orig_w = cam_info.image.shape[:2]

    if args.resolution in [1, 2, 4, 8]:
        resolution = (
            round(orig_w / (resolution_scale * args.resolution)),
            round(orig_h / (resolution_scale * args.resolution)),
        )
    else:
        if args.resolution == -1:
            if orig_w > 1600:
                global _warned
                if not _warned:
                    print(
                        "[ INFO ] Encountered quite large input images (>1.6K pixels width), "
                        "rescaling to 1.6K.\n If this is not desired, please explicitly "
                        "specify '--resolution/-r' as 1"
                    )
                    _warned = True
                global_down = orig_w / 1600
            else:
                global_down = 1
        else:
            global_down = orig_w / args.resolution
        scale = float(global_down) * float(resolution_scale)
        resolution = (int(orig_w / scale), int(orig_h / scale))

    resized_rgb = image_to_array(cam_info.image, resolution)
    gt_image = resized_rgb[:3, ...]
    loaded_mask = resized_rgb[3:4, ...] if resized_rgb.shape[0] == 4 else None

    return Camera.create(
        colmap_id=cam_info.uid,
        R=cam_info.R,
        T=cam_info.T,
        fovx=cam_info.FovX,
        fovy=cam_info.FovY,
        image=gt_image,
        gt_alpha_mask=loaded_mask,
        image_name=cam_info.image_name,
        uid=id,
        device=device,
    )


def camera_list_from_cam_infos(cam_infos, resolution_scale, args, device=None):
    return [load_cam(args, id, c, resolution_scale, device) for id, c in enumerate(cam_infos)]

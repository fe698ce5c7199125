"""The paper's own workload: OpenPose (CMU body-25/COCO) on Caffe.

This file records the workload constants used throughout the paper-table
benchmarks: frame geometry, Eq. 1 data-transfer accounting constants, and the
estimated forward-pass FLOPs of the OpenPose COCO body model at the paper's
input resolution (368x656).  The runnable miniature of the backbone lives in
``repro_torch.models.openpose``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class OpenPoseWorkload:
    # Paper §V: frame dims 1 x 3 x 368 x 656, model constant c = 3.368421.
    frame_c: int = 3
    frame_h: int = 368
    frame_w: int = 656
    output_divisor: float = 3.368421
    video_frames: int = 204          # 8 s clip
    image_batches: tuple = (64, 128, 256)
    # OpenPose COCO model: ~52k x 38k-ish multi-stage CNN. Public estimates put
    # the body-COCO forward pass at ~160 GFLOPs at 368x656 input; this anchors
    # the calibrated cost model (see core/costmodel.py calibration numbers).
    forward_flops: float = 160e9
    # COCO caffemodel on-GPU footprint per paper §V.2 ("requires up about
    # 5.5GB of memory on the GPU" including workspace); weights file ~200MB.
    model_weight_bytes: float = 200e6
    model_gpu_bytes: float = 5.5e9

    @property
    def dims(self) -> int:
        return self.frame_c * self.frame_h * self.frame_w

    def data_transfer_bytes(self) -> float:
        """Eq. 1: DT = (2*4) + (1*4) + Dims*4 + (Dims/c)*4 bytes/frame."""
        d = self.dims
        return (2 * 4) + (1 * 4) + d * 4 + (d / self.output_divisor) * 4


WORKLOAD = OpenPoseWorkload()

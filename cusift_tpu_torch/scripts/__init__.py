"""The port's measurement entry points beside `bench.py`, twins of the
repository's `scripts/` (which measure the JAX package on a TPU):
`stage_times` (per-stage cost of the batched extraction),
`stereo_longrun` (the north-star stereo and RGB-D loops) and `endurance`
(4,541 frames through `StereoSlam`).  Run each as
`python -m cusift_tpu_torch.scripts.<name>`; importing one runs nothing."""

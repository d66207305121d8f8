"""The perception front end: the FastSAM-x segmentation net, the DINOv2
and CLIP ViT encoders, and the batched RGB-D front end that turns frames
into per-mask observations (a port of roman_tpu/perception)."""

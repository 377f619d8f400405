"""Global constants (the port's copy of ``implicit_depth_tpu/constants.py``)."""

# ImageNet normalization used for RGB standardization.
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_NORM = (0.229, 0.224, 0.225)

# Camera-frustum AABB voxelized by the LIDF grid (meters, camera space).
XMIN = (-1.0, -1.0, 0.0)
XMAX = (1.0, 1.0, 2.0)

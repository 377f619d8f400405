"""The data-parallel runtime (counterpart of
``implicit_depth_tpu/parallel``): the process group and its collectives
(``mesh``), and hard-negative mining over the global batch (``hardneg``)."""

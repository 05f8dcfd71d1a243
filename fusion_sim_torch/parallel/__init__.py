"""Meshes, placements, halo exchange and particle migration on
``torch.distributed`` (port of ``fusion_sim_tpu/parallel/``)."""

"""Port of the palu_tpu.ops package."""

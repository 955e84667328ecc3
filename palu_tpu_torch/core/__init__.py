"""Port of the palu_tpu.core package."""

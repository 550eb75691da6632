"""Training (counterpart of sdxl_tpu/train/): LoRA fine-tuning of the
SDXL UNet — factors, the diffusion loss, the AdamW step and the loop."""

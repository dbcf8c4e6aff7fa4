"""Single-card training of PixArt: the iDDPM loss, CAME, EMA and the trainer,
and the fine-tuning and distillation steps (LoRA/DoRA, DreamBooth, LCM,
DMD)."""

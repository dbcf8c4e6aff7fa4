"""Entry points run as modules: `serve` (HTTP server with micro-batching),
`inference` (a prompt file to images), `train` (the training CLI), and the
fine-tuning and distillation CLIs `train_pixart_lora`,
`train_dreambooth_lora`, `train_pixart_lcm` and `train_pixart_dmd`."""

"""PixArt-Sigma in PyTorch with hand-written CUDA kernels for the H100.

The port of the JAX package `pixart_sigma_tpu`: the same module paths, the
same public layouts (NHWC latents, [B, N, H, Dh] attention), and weights
carried across with `utils.checkpoint`. It imports neither JAX nor the JAX
package. Entry points run on the card unless the caller passes
`device="cpu"`.
"""


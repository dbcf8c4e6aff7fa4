from pixart_sigma_tpu_torch.pipelines.pipeline import PixArtPipeline

__all__ = ["PixArtPipeline"]

"""The training diffusion (iDDPM flavour); port of
pixart_sigma_tpu/diffusion/factory.py."""

from __future__ import annotations

from pixart_sigma_tpu_torch.diffusion.gaussian import LossType, ModelMeanType, ModelVarType
from pixart_sigma_tpu_torch.diffusion.respace import SpacedDiffusion, space_timesteps
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule


def IDDPM(
    timestep_respacing=None,
    noise_schedule: str = "linear",
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    pred_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
) -> SpacedDiffusion:
    """A SpacedDiffusion configured like the reference's IDDPM(). Its
    use_kl, sigma_small and snr switches are not ported (GaussianDiffusion
    says which variants are), nor is a fixed variance (learn_sigma=False)."""
    if pred_sigma and not learn_sigma:
        raise NotImplementedError("fixed variances are not ported (learn_sigma=False)")
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    return SpacedDiffusion.from_betas(
        betas=named_beta_schedule(noise_schedule, diffusion_steps),
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=ModelVarType.LEARNED_RANGE if pred_sigma else None,
        loss_type=LossType.RESCALED_MSE if rescale_learned_sigmas else LossType.MSE,
    )

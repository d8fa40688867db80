from lanczos_torch.utils.metrics import psnr, rms_error  # noqa: F401

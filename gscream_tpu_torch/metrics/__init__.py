"""Evaluation metrics: LPIPS (PSNR and SSIM are in ``ops``)."""

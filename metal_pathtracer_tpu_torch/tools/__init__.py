"""The port's training and evaluation tools for its denoisers
(``train_denoiser``, ``train_denoiser_unet``, ``denoise_quality``)."""

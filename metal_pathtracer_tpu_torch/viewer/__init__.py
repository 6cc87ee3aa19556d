from metal_pathtracer_tpu_torch.viewer.server import ViewerServer, main

from icek_torch.serve.engine import ServeStats, ServingEngine  # noqa: F401

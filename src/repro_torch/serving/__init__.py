from repro_torch.serving.engine import ServingEngine, Request, Result

__all__ = ["ServingEngine", "Request", "Result"]

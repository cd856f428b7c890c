from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["ServeEngine", "Request"]

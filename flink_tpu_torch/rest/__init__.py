from flink_tpu_torch.rest.server import RestServer

__all__ = ["RestServer"]

"""Deployment renderers: Kubernetes manifests and the container image (port
of ``flink_tpu/deploy``)."""

from flink_tpu_torch.deploy.kubernetes import render_job_cluster

__all__ = ["render_job_cluster"]

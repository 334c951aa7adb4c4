"""Container image glue: Dockerfile + compose rendering for the cluster
entrypoints (port of ``flink_tpu/deploy/docker.py``: the image runs
``python -m flink_tpu_torch`` on a CUDA base that carries ``nvcc``).

The reference ships ``flink-container/`` (Dockerfile, ``docker-compose``
templates, ``docker-entrypoint.sh`` dispatching jobmanager/taskmanager
roles).  Same shape here, for the ``python -m flink_tpu_torch coordinate`` /
``worker`` entrypoints already used by the Kubernetes manifests
(``deploy/kubernetes.py``): :func:`render_dockerfile` emits a
reproducible image recipe, :func:`render_entrypoint` the role-dispatch
script, :func:`render_compose` a coordinator + N workers compose file
sharing a checkpoint volume, and :func:`write_context` lays the whole
build context down on disk.  Rendering is pure (testable in-repo; the
docker daemon is not available here) — the emitted files are standard
and build anywhere."""

from __future__ import annotations

import os
from typing import Dict, List, Optional


#: the image's base: the CUDA toolkit's development image, whose ``nvcc``
#: builds the port's kernels (``csrc/*.cu``) at first use
CUDA_BASE = "nvidia/cuda:12.6.3-devel-ubuntu24.04"


def render_dockerfile(python: str = "3.12",
                      extras: Optional[List[str]] = None) -> str:
    """A minimal reproducible image: the package with its ``csrc/``, its
    baked deps, one non-root user, both cluster roles reachable through the
    entrypoint.  ``python`` names the interpreter the base's apt installs
    (``python3.12`` on Ubuntu 24.04)."""
    lines = [
        f"FROM {CUDA_BASE}",
        "",
        "# nvcc (from the base) builds the CUDA kernels at first use; g++",
        "# builds the host C libraries (csrc/*.cc)",
        "RUN apt-get update && apt-get install -y --no-install-recommends \\",
        f"        python{python} python{python}-venv g++ \\",
        "        && rm -rf /var/lib/apt/lists/*",
        f"RUN python{python} -m venv /srv/venv",
        "ENV PATH=/srv/venv/bin:$PATH",
        "RUN pip install --no-cache-dir torch numpy pyyaml cryptography",
        "",
        "RUN useradd --create-home flink",
        "WORKDIR /srv/flink-tpu",
        "COPY flink_tpu_torch ./flink_tpu_torch",
        "ENV PYTHONPATH=/srv/flink-tpu",
    ]
    for e in extras or []:
        lines.append(f"RUN pip install --no-cache-dir {e}")
    lines += [
        "",
        "# pre-build the host C libraries into the image (first-use cache);",
        "# a failed C++ build FAILS the image build (each build raises with",
        "# the compiler's output); the kernels' build directory stays",
        "# writable for the first use of the CUDA kernels",
        "RUN python -c \"from flink_tpu_torch.kernels import build; "
        "[build.build_host(s) for s in (build.HOST_SOURCE, "
        "build.SPILL_SOURCE, build.CODEC_SOURCE)]\" \\",
        "        && chown -R flink /srv/flink-tpu/flink_tpu_torch",
        "",
        "COPY docker-entrypoint.sh /docker-entrypoint.sh",
        "RUN chmod +x /docker-entrypoint.sh",
        "USER flink",
        "EXPOSE 6123 8081",
        'ENTRYPOINT ["/docker-entrypoint.sh"]',
        'CMD ["help"]',
        "",
    ]
    return "\n".join(lines)


def render_entrypoint() -> str:
    """Role dispatch (``docker-entrypoint.sh`` analog): coordinate |
    worker | sql | repl | any module args verbatim."""
    return """#!/bin/sh
# flink-tpu container entrypoint: dispatch the cluster role.
set -e

ROLE="$1"
[ $# -gt 0 ] && shift

case "$ROLE" in
    run|sql|info|repl|worker|coordinate|logservice|objectstore|s3|kafka|\
quickstart|list|status|cancel|savepoint|stop)
        # every CLI subcommand (flink_tpu_torch.__main__ build_parser surface)
        exec python -m flink_tpu_torch "$ROLE" "$@"
        ;;
    help|"")
        echo "usage: <any flink_tpu_torch subcommand|shell cmd> [args...]"
        exec python -m flink_tpu_torch --help
        ;;
    *)
        # arbitrary command (debugging shells, custom drivers)
        exec "$ROLE" "$@"
        ;;
esac
"""


def coordinator_command(job: str, n_workers: int, port: int,
                        checkpoint_dir: Optional[str]) -> List[str]:
    """The coordinate role's entrypoint args — the SAME flag surface the
    Kubernetes renderer emits (``deploy/kubernetes.py``), validated
    against the real CLI parser in tests."""
    cmd = ["coordinate", "--job", job, "--workers", str(n_workers),
           "--listen", f"0.0.0.0:{port}"]
    if checkpoint_dir:
        cmd += ["--checkpoint-dir", checkpoint_dir]
    return cmd


def worker_command(index: int, job: str, n_workers: int,
                   coordinator: str) -> List[str]:
    """One worker replica's entrypoint args (``--index`` is per-service:
    compose has no pod-index analog, so each worker renders as its own
    service)."""
    return ["worker", "--index", str(index), "--workers", str(n_workers),
            "--job", job, "--coordinator", coordinator,
            "--bind", "0.0.0.0", "--advertise", f"worker-{index}"]


def _yq(v: str) -> str:
    """A YAML double-quoted scalar (json.dumps escapes quotes/backslashes
    exactly as YAML flow scalars require)."""
    import json

    return json.dumps(str(v))


def _yaml_cmd(args: List[str]) -> str:
    return "[" + ", ".join(_yq(a) for a in args) + "]"


def render_compose(job: str, image: str = "flink-tpu:latest",
                   n_workers: int = 2, coordinator_port: int = 6123,
                   environment: Optional[Dict[str, str]] = None) -> str:
    """docker-compose: one coordinator + one service PER worker index
    (each worker needs a distinct ``--index``; compose replicas cannot
    vary args), sharing a checkpoint volume.  The compose network is the
    trust boundary, so the non-loopback TLS guard is relaxed via
    ``FLINK_TPU_ALLOW_INSECURE`` — set ``FLINK_TPU_SSL_*`` instead for
    untrusted networks.  Each worker reserves one card (a worker runs on
    the card unless told ``--device cpu``).  Healthcheck: a TCP dial of the control port (the
    coordinate role serves the binary control plane, not HTTP)."""
    env_lines = "".join(f"      {k}: {_yq(v)}\n"
                        for k, v in (environment or {}).items())
    base_env = "      FLINK_TPU_ALLOW_INSECURE: \"1\"\n" + env_lines
    coord = coordinator_command(job, n_workers, coordinator_port,
                                "/checkpoints")
    parts = [f"""services:
  coordinator:
    image: {image}
    command: {_yaml_cmd(coord)}
    expose:
      - "{coordinator_port}"
    environment:
{base_env}    volumes:
      - checkpoints:/checkpoints
    healthcheck:
      test: ["CMD", "python", "-c",
             "import socket; socket.create_connection(('127.0.0.1', {coordinator_port}), 5).close()"]
      interval: 10s
      retries: 6
"""]
    for i in range(n_workers):
        wcmd = worker_command(i, job, n_workers,
                              f"coordinator:{coordinator_port}")
        parts.append(f"""
  worker-{i}:
    image: {image}
    command: {_yaml_cmd(wcmd)}
    depends_on:
      coordinator:
        condition: service_healthy
    restart: on-failure
    environment:
{base_env}    volumes:
      - checkpoints:/checkpoints
    deploy:
      resources:
        reservations:
          devices:
            - driver: nvidia
              count: 1
              capabilities: [gpu]
""")
    parts.append("""
volumes:
  checkpoints:
""")
    return "".join(parts)


def write_context(directory: str, job: str, image: str = "flink-tpu:latest",
                  n_workers: int = 2, python: str = "3.12",
                  repo_root: Optional[str] = None) -> List[str]:
    """Lay a SELF-CONTAINED build context on disk: Dockerfile, entrypoint,
    compose, plus the package the Dockerfile COPYs (``flink_tpu_torch/``
    with its ``csrc/``) and ``README.md`` —
    ``docker build <directory>`` works as-is.  ``repo_root`` defaults to
    this installation's root."""
    import shutil

    os.makedirs(directory, exist_ok=True)
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    out = []
    for fname in ("README.md",):
        src = os.path.join(repo_root, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(directory, fname))
            out.append(os.path.join(directory, fname))
    for pkg in ("flink_tpu_torch",):
        src = os.path.join(repo_root, pkg)
        dst = os.path.join(directory, pkg)
        if os.path.isdir(src):
            shutil.copytree(
                src, dst, dirs_exist_ok=True,
                ignore=shutil.ignore_patterns("__pycache__", "_build",
                                              "*.so", "*.pyc"))
            out.append(dst)
    files = {
        "Dockerfile": render_dockerfile(python=python),
        "docker-entrypoint.sh": render_entrypoint(),
        "docker-compose.yml": render_compose(job, image=image,
                                             n_workers=n_workers),
    }
    for name, content in files.items():
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(content)
        if name.endswith(".sh"):
            os.chmod(path, 0o755)
        out.append(path)
    return out

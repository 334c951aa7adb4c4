"""Port parity for the edges: the CDC formats and the deployment renderers.
The reference's cases of ``tests/test_cdc.py``, ``test_deploy.py`` and
``test_docker_deploy.py`` run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks.

Four cases have counterparts here (``OWN_COUNTERPART`` of the harness):
the port's image is built on a CUDA development base, whose ``nvcc``
builds the kernels at first use, and ships ``csrc/`` inside its package
where JAX's copies ``native/``; and a worker started by hand, as a pod
would start it, runs on the card unless its command says ``--device cpu``.
Each counterpart patches the port's run alone, and every other assertion
stands as written.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_cdc", "test_deploy", "test_docker_deploy")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


#: what the port's image holds in place of JAX's base and ``native/``
DOCKER = {
    "test_dockerfile_structure": (
        ('assert df.startswith("FROM python:3.12-slim")',
         'assert df.startswith("FROM nvidia/cuda:") and "-devel-" in df\n'
         '        assert "python3.12 python3.12-venv g++" in df'),
        ('assert "COPY native ./native" in df          # C++ sources ship',
         'assert "build.build_host(s)" in df  # C++ sources build in it'),
    ),
    "test_write_context_is_self_contained": (
        ('os.path.join(ctx, "native",\n'
         '                                           "flink_native.cc")',
         'os.path.join(ctx, "flink_tpu", "csrc",\n'
         '                                           "codec.cc")'),
    ),
}


@pytest.mark.parametrize("fn_name", sorted(DOCKER))
def test_docker_rendering_with_the_ports_image(fn_name, tmp_path_factory,
                                               verdicts):  # noqa: F811
    """``test_docker_deploy.py``'s image cases on both packages: the port's
    Dockerfile starts from the CUDA development image (with the Python and
    the ``g++`` its apt installs), builds the host C libraries in the image
    and copies the package with its ``csrc/``."""
    check_case("test_docker_deploy", "TestRendering", fn_name, {},
               tmp_path_factory, verdicts, port_patches=DOCKER[fn_name])


#: the worker commands of ``test_deploy.py``, told the CPU on the port's side
WORKERS = {
    "test_external_workers_register_and_run": (
        ('"--bind", "127.0.0.1", "--advertise", "127.0.0.1"],',
         '"--bind", "127.0.0.1", "--advertise", "127.0.0.1",\n'
         '             "--device", "cpu"],'),),
    "test_stray_connection_does_not_kill_registration": (
        ('"--coordinator", f"127.0.0.1:{pc.control_port}"], env=env)',
         '"--coordinator", f"127.0.0.1:{pc.control_port}",\n'
         '             "--device", "cpu"], env=env)'),),
}


@pytest.mark.parametrize("fn_name", sorted(WORKERS))
def test_external_workers_on_both_packages(fn_name, tmp_path_factory,
                                           verdicts):  # noqa: F811
    """``test_deploy.py``'s hand-started workers (the k8s pod flow) on both
    packages, the port's workers started with ``--device cpu``: a
    ``spawn=False`` coordinator waits, the workers register over the
    control port (past a readiness probe's stray connections) and the job
    finishes with the reference's rows."""
    check_case("test_deploy", None, fn_name, {}, tmp_path_factory,
               verdicts, port_patches=WORKERS[fn_name])


def test_rendered_manifests_and_image_name_the_port():
    """The port's manifests, compose file and entrypoint run ``python -m
    flink_tpu_torch``; a worker's card is a resource on its limits, and the
    compose file reserves one card a worker; JAX's renderers give the same
    documents with its own module name, the CUDA parts aside."""
    import json

    import yaml

    from flink_tpu.deploy import docker as jdocker
    from flink_tpu.deploy import kubernetes as jk8s
    from flink_tpu_torch.deploy import docker as pdocker
    from flink_tpu_torch.deploy import kubernetes as pk8s
    kw = dict(n_workers=2, checkpoint_dir="/ckpt", checkpoint_interval_ms=500,
              tpu_resource={"nvidia.com/gpu": 1}, env={"A": "1"})
    port = pk8s.render_job_cluster("wc", "img:1", "jobs:build", **kw)
    ref = jk8s.render_job_cluster("wc", "img:1", "jobs:build", **kw)
    text = json.dumps(port)
    assert "flink_tpu_torch" in text
    assert text.replace("flink_tpu_torch", "flink_tpu") == json.dumps(ref)
    assert list(yaml.safe_load_all(pk8s.to_yaml(port))) == port
    worker = port[3]["spec"]["template"]["spec"]["containers"][0]
    assert worker["resources"] == {"limits": {"nvidia.com/gpu": 1}}
    assert "exec python -m flink_tpu_torch worker" in worker["command"][2]
    compose = yaml.safe_load(pdocker.render_compose("j:build", n_workers=2))
    for i in range(2):
        dev = compose["services"][f"worker-{i}"]["deploy"]["resources"][
            "reservations"]["devices"]
        assert dev == [{"driver": "nvidia", "count": 1,
                        "capabilities": ["gpu"]}]
    assert "deploy" not in compose["services"]["coordinator"]
    jcompose = yaml.safe_load(jdocker.render_compose("j:build", n_workers=2))
    assert compose["services"]["coordinator"]["command"] == \
        jcompose["services"]["coordinator"]["command"]
    assert "JAX_PLATFORMS" not in str(compose)
    ep = pdocker.render_entrypoint()
    assert ep.replace("flink_tpu_torch", "flink_tpu") == \
        jdocker.render_entrypoint()


def test_config_docs_match_the_reference():
    """``config/docgen.py`` renders the port's option classes into the same
    configuration reference as JAX's, the package's name aside."""
    from flink_tpu.config import docgen as jdoc
    from flink_tpu_torch.config import docgen as pdoc
    port = pdoc.render_markdown()
    assert "`flink_tpu_torch/config/options.py`" in port
    assert port.replace("flink_tpu_torch", "flink_tpu") == \
        jdoc.render_markdown()
    assert [g for g, _ in pdoc.collect_option_groups()] == \
        [g for g, _ in jdoc.collect_option_groups()]

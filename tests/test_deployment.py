"""Deployment + documentation structural tests.

The reference tests deployment correctness *statically* by parsing manifests
and asserting invariants — non-root users, probes, resource limits, RBAC,
no hardcoded secrets, overlay structure, chart/values consistency
(tests/python/deployment/test_deployment.py:33-371) — and guards
documentation drift (test_documentation.py).  Same strategy, same depth.
"""

import json
import re
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parents[1]
DOCKER = ROOT / "deploy" / "docker"
K8S = ROOT / "deploy" / "k8s"
HELM = ROOT / "deploy" / "helm" / "pde-tpu"

SERVICE_DOCKERFILES = [
    "Dockerfile.base", "Dockerfile.api", "Dockerfile.calibration",
    "Dockerfile.signals", "Dockerfile.execution", "Dockerfile.data-ingestion",
]


class TestDockerfiles:
    @pytest.fixture(scope="class")
    def dockerfiles(self):
        return {name: (DOCKER / name).read_text()
                for name in ["Dockerfile", *SERVICE_DOCKERFILES]}

    def test_per_service_dockerfiles_exist(self):
        for name in SERVICE_DOCKERFILES:
            assert (DOCKER / name).exists(), name

    def test_non_root_user(self, dockerfiles):
        # base creates + switches to the unprivileged user; service images
        # inherit it (FROM pde-tpu-base)
        assert "USER app" in dockerfiles["Dockerfile.base"]
        assert "useradd" in dockerfiles["Dockerfile.base"]
        assert "USER app" in dockerfiles["Dockerfile"]

    def test_service_images_build_from_base(self, dockerfiles):
        for name in SERVICE_DOCKERFILES:
            if name == "Dockerfile.base":
                continue
            assert "FROM pde-tpu-base" in dockerfiles[name], name

    def test_healthchecks_present(self, dockerfiles):
        for name, text in dockerfiles.items():
            if name == "Dockerfile.base":
                continue  # base is not a runnable service
            assert "HEALTHCHECK" in text, name

    def test_service_entrypoints_resolve(self, dockerfiles):
        """Every CMD module/function referenced by a Dockerfile must exist —
        the reference's Dockerfiles point at quant_trading.*.service modules
        that do not exist in its tree; do not repeat that."""
        import pde_tpu.services as services

        for name, text in dockerfiles.items():
            m = re.search(r'CMD \["python", "-m", "pde_tpu.services", "([a-z-]+)"\]', text)
            if m:
                assert m.group(1) in services._STEPS, name

    def test_no_hardcoded_secrets(self, dockerfiles):
        for name, text in dockerfiles.items():
            assert not re.search(r"(PASSWORD|SECRET|API_KEY)\s*=", text, re.IGNORECASE), name


class TestCompose:
    @pytest.fixture(scope="class")
    def compose(self):
        return yaml.safe_load((DOCKER / "docker-compose.yml").read_text())

    def test_all_services_present(self, compose):
        assert {
            "data-api", "nginx", "calibration", "signals", "execution",
            "data-ingestion", "prometheus", "grafana",
        } <= set(compose["services"])

    def test_restart_policies(self, compose):
        for name, svc in compose["services"].items():
            if name == "base":
                continue  # build-only image, runs once
            assert svc.get("restart") == "unless-stopped", name

    def test_grafana_password_via_secret(self, compose):
        g = compose["services"]["grafana"]
        env = g.get("environment", {})
        assert all("PASSWORD" not in str(v).upper() or "FILE" in k
                   for k, v in env.items())
        assert "secrets" in g

    def test_nginx_fronts_the_api(self, compose):
        nginx_conf = (DOCKER / "nginx" / "nginx.conf").read_text()
        assert "data-api:8080" in nginx_conf
        assert "data-api" in compose["services"]["nginx"].get("depends_on", [])

    def test_grafana_provisioning_complete(self):
        ds = yaml.safe_load(
            (DOCKER / "grafana" / "provisioning" / "datasources" / "datasources.yml").read_text()
        )
        assert ds["datasources"][0]["type"] == "prometheus"
        dashboards = list((DOCKER / "grafana" / "dashboards").glob("*.json"))
        assert len(dashboards) >= 4  # trading / risk / system / data
        for p in dashboards:
            json.loads(p.read_text())  # must be valid dashboard JSON


class TestK8sBase:
    @pytest.fixture(scope="class")
    def manifests(self):
        docs = []
        for path in (K8S / "base").glob("*.yaml"):
            docs.extend(d for d in yaml.safe_load_all(path.read_text()) if d)
        return docs

    def _by_kind(self, manifests, kind):
        return [d for d in manifests if d.get("kind") == kind]

    def test_namespace_and_quota_defined(self, manifests):
        assert self._by_kind(manifests, "Namespace")
        assert self._by_kind(manifests, "ResourceQuota")

    def test_all_services_deployed(self, manifests):
        names = {d["metadata"]["name"] for d in self._by_kind(manifests, "Deployment")}
        assert {
            "pde-tpu-data-api", "pde-tpu-calibration", "pde-tpu-signals",
            "pde-tpu-execution", "pde-tpu-data-ingestion",
        } <= names

    def test_deployments_have_probes_and_limits(self, manifests):
        for d in self._by_kind(manifests, "Deployment"):
            for c in d["spec"]["template"]["spec"]["containers"]:
                assert "livenessProbe" in c, d["metadata"]["name"]
                assert "readinessProbe" in c, d["metadata"]["name"]
                assert "limits" in c["resources"], d["metadata"]["name"]
                assert "requests" in c["resources"], d["metadata"]["name"]

    def test_non_root_security_context(self, manifests):
        kinds = ("Deployment", "CronJob")
        for d in manifests:
            if d["kind"] not in kinds:
                continue
            tpl = (d["spec"]["template"] if d["kind"] == "Deployment"
                   else d["spec"]["jobTemplate"]["spec"]["template"])
            sc = tpl["spec"].get("securityContext", {})
            assert sc.get("runAsNonRoot") is True, d["metadata"]["name"]

    def test_calibration_runs_on_gpu_nodes(self, manifests):
        cal = next(d for d in self._by_kind(manifests, "Deployment")
                   if d["metadata"]["name"] == "pde-tpu-calibration")
        spec = cal["spec"]["template"]["spec"]
        assert "cloud.google.com/gke-accelerator" in spec.get("nodeSelector", {})
        res = spec["containers"][0]["resources"]
        assert "nvidia.com/gpu" in res["requests"]
        assert "nvidia.com/gpu" in res["limits"]

    def test_calibration_batch_job_requests_gpu(self, manifests):
        jobs = [d for d in self._by_kind(manifests, "CronJob")
                if "calibration" in d["metadata"]["name"]]
        assert jobs
        c = jobs[0]["spec"]["jobTemplate"]["spec"]["template"]["spec"]["containers"][0]
        assert "nvidia.com/gpu" in c["resources"]["requests"]

    def test_execution_is_a_recreate_singleton(self, manifests):
        ex = next(d for d in self._by_kind(manifests, "Deployment")
                  if d["metadata"]["name"] == "pde-tpu-execution")
        assert ex["spec"]["replicas"] == 1
        assert ex["spec"]["strategy"]["type"] == "Recreate"

    def test_rbac_least_privilege(self, manifests):
        roles = self._by_kind(manifests, "Role")
        assert roles
        for role in roles:
            for rule in role["rules"]:
                assert "*" not in rule.get("verbs", []), role["metadata"]["name"]
                assert not ({"create", "delete"} & set(rule.get("verbs", [])))
        assert self._by_kind(manifests, "RoleBinding")
        sas = self._by_kind(manifests, "ServiceAccount")
        assert any(sa.get("automountServiceAccountToken") is False for sa in sas)

    def test_pdb_and_network_policy(self, manifests):
        assert self._by_kind(manifests, "PodDisruptionBudget")
        assert self._by_kind(manifests, "NetworkPolicy")

    def test_secrets_are_templates_only(self, manifests):
        for s in self._by_kind(manifests, "Secret"):
            for v in s.get("stringData", {}).values():
                assert v == "REPLACE_ME", "secret manifest must stay a template"

    def test_db_pvc_and_backup(self, manifests):
        pvcs = {d["metadata"]["name"] for d in self._by_kind(manifests, "PersistentVolumeClaim")}
        assert {"pde-tpu-db", "pde-tpu-db-backups"} <= pvcs
        assert any("backup" in d["metadata"]["name"]
                   for d in self._by_kind(manifests, "CronJob"))

    def test_no_hardcoded_secrets(self, manifests):
        text = json.dumps(manifests)
        assert "password" not in text.lower()

    def test_kustomization_lists_every_manifest(self):
        kust = yaml.safe_load((K8S / "base" / "kustomization.yaml").read_text())
        listed = set(kust["resources"])
        present = {p.name for p in (K8S / "base").glob("*.yaml")} - {"kustomization.yaml"}
        assert listed == present


class TestK8sOverlays:
    @pytest.mark.parametrize("env", ["dev", "prod"])
    def test_overlay_valid(self, env):
        kust = yaml.safe_load((K8S / "overlays" / env / "kustomization.yaml").read_text())
        assert "../../base" in kust["resources"]
        assert kust.get("namespace"), env

    def test_dev_strips_gpu(self):
        kust = yaml.safe_load((K8S / "overlays" / "dev" / "kustomization.yaml").read_text())
        text = yaml.dump(kust)
        assert "nvidia.com~1gpu" in text  # removes the GPU resource requests

    def test_prod_scales_up(self):
        kust = yaml.safe_load((K8S / "overlays" / "prod" / "kustomization.yaml").read_text())
        patches = yaml.dump(kust)
        assert "replicas" in patches


class TestHelmChart:
    @pytest.fixture(scope="class")
    def chart(self):
        return yaml.safe_load((HELM / "Chart.yaml").read_text())

    @pytest.fixture(scope="class")
    def values(self):
        return yaml.safe_load((HELM / "values.yaml").read_text())

    def test_chart_metadata(self, chart):
        assert chart["apiVersion"] == "v2"
        assert chart["name"] == "pde-tpu"
        assert chart["version"]
        assert chart["appVersion"]

    def test_all_services_configurable(self, values):
        assert {"api", "calibration", "signals", "execution", "dataIngestion"} <= set(
            values["services"]
        )
        for svc in values["services"].values():
            assert "enabled" in svc and "replicas" in svc and "resources" in svc

    def test_gpu_knobs(self, values):
        gpu = values["services"]["calibration"]["gpu"]
        assert {"enabled", "accelerator", "count"} <= set(gpu)

    def test_security_defaults(self, values):
        assert values["securityContext"]["runAsNonRoot"] is True
        assert values["secrets"]["create"] is False  # secret manager by default
        assert values["secrets"]["dataApiKey"] == ""

    def test_templates_exist(self):
        names = {p.name for p in (HELM / "templates").glob("*")}
        assert {
            "_helpers.tpl", "api-deployment.yaml", "calibration-deployment.yaml",
            "workers-deployment.yaml", "secrets.yaml", "storage.yaml",
        } <= names

    def test_templates_only_reference_defined_values(self, values):
        """Cheap helm-lint substitute (no helm binary in this image): every
        .Values.x.y.z path used in templates must exist in values.yaml."""
        def resolve(path):
            node = values
            for part in path.split(".")[1:]:  # drop leading 'Values'
                if not isinstance(node, dict) or part not in node:
                    return False
                node = node[part]
            return True

        for tpl in (HELM / "templates").glob("*.yaml"):
            for m in re.finditer(r"\.Values(\.[A-Za-z0-9_]+)+", tpl.read_text()):
                path = m.group(0).lstrip(".")
                # range-scoped locals ($svc.*) and dict lookups are exempt
                assert resolve(path), f"{tpl.name}: {m.group(0)} not in values.yaml"


class TestScripts:
    @pytest.mark.parametrize("script", ["backup.sh", "restore.sh"])
    def test_scripts_have_error_handling(self, script):
        text = (ROOT / "deploy" / "scripts" / script).read_text()
        assert "set -e" in text or "set -euo" in text, script


class TestCI:
    def test_ci_workflow_valid(self):
        wf = yaml.safe_load((ROOT / ".github" / "workflows" / "ci.yml").read_text())
        assert wf.get("jobs")
        on = wf.get("on") or wf.get(True)  # yaml 1.1 parses 'on' as True
        assert on is not None

    def test_build_workflow_covers_native_package_and_images(self):
        """Role parity with the reference's build.yml: native build + tests,
        Python packaging, per-service images."""
        wf = yaml.safe_load(
            (ROOT / ".github" / "workflows" / "build.yml").read_text())
        jobs = wf["jobs"]
        assert {"native", "package", "images"} <= set(jobs)
        native_cmds = " ".join(
            s.get("run", "") for s in jobs["native"]["steps"])
        assert "make native" in native_cmds and "make test-cpp" in native_cmds
        # every image in the matrix has its Dockerfile, and vice versa
        matrix = set(jobs["images"]["strategy"]["matrix"]["service"])
        on_disk = {
            p.name.split(".", 1)[1]
            for p in DOCKER.glob("Dockerfile.*") if p.name != "Dockerfile.base"
        }
        assert matrix == on_disk, (matrix, on_disk)

    def test_cd_workflow_deploys_every_service(self):
        """Role parity with the reference's cd.yml: image push, helm package,
        environment-gated deploys, rollback — and the rollout targets must
        be REAL deployment names from deploy/k8s/base."""
        wf = yaml.safe_load(
            (ROOT / ".github" / "workflows" / "cd.yml").read_text())
        jobs = wf["jobs"]
        assert {"build-push", "helm-package", "deploy-dev", "deploy-prod",
                "rollback"} <= set(jobs)
        # rollout waits reference real Deployment names
        deployed = set()
        for path in (K8S / "base").glob("*-deployment.yaml"):
            for doc in yaml.safe_load_all(path.read_text()):
                if doc and doc.get("kind") == "Deployment":
                    deployed.add(doc["metadata"]["name"])
        for job in ("deploy-dev", "deploy-prod"):
            cmds = " ".join(s.get("run", "") for s in jobs[job]["steps"])
            waited = set(re.findall(r"(pde-tpu-[a-z-]+)", cmds)) & deployed
            assert waited == deployed, (job, deployed - waited)
        # the packaged chart is the repo chart, and the release uses it
        helm_cmds = " ".join(
            s.get("run", "") for s in jobs["helm-package"]["steps"])
        assert "deploy/helm/pde-tpu" in helm_cmds
        prod_cmds = " ".join(
            s.get("run", "") for s in jobs["deploy-prod"]["steps"])
        assert "helm upgrade" in prod_cmds and "rollout status" in prod_cmds
        assert "rollback" in " ".join(
            s.get("run", "") for s in jobs["rollback"]["steps"])


class TestPrometheus:
    def test_scrape_config(self):
        cfg = yaml.safe_load((DOCKER / "prometheus" / "prometheus.yml").read_text())
        assert cfg["scrape_configs"][0]["job_name"] == "pde-tpu"


class TestDocumentation:
    REQUIRED = ["README.md", "SURVEY.md", "BASELINE.md", "docs/architecture.md",
                "sql/schema.sql", "config/default.json", "Makefile"]

    def test_required_docs_exist(self):
        for rel in self.REQUIRED:
            assert (ROOT / rel).exists(), rel

    def test_readme_mentions_entry_points(self):
        readme = (ROOT / "README.md").read_text()
        for token in ("bench.py", "pytest", "pde_tpu.cli"):
            assert token in readme, token

    def test_architecture_doc_layer_map(self):
        doc = (ROOT / "docs" / "architecture.md").read_text()
        for token in ("Layer map", "Scaling model", "Correctness strategy"):
            assert token in doc

    def test_default_config_parses(self):
        from pde_tpu.core.config import Config

        cfg = Config.from_file(str(ROOT / "config" / "default.json"))
        assert cfg.trading.initial_capital > 0

    def test_schema_sql_matches_runtime_schema(self):
        """Every table created by the runtime exists in the exported DDL."""
        sql = (ROOT / "sql" / "schema.sql").read_text()
        from pde_tpu.database import TimeSeriesDB
        from pde_tpu.database.migrations import MigrationRunner

        db = TimeSeriesDB(":memory:")
        MigrationRunner(db).upgrade()
        tables = [
            r[0] for r in db._conn().execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            ).fetchall()
            if not r[0].startswith("sqlite_") and r[0] != "schema_version"
        ]
        for t in tables:
            assert t in sql, f"table {t} missing from sql/schema.sql"

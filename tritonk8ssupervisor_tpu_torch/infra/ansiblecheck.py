"""Structural + expression validation for the ansible surface.

`ansible-playbook --syntax-check` needs ansible installed; this gives the
dev loop the same floor (and more) without it:

- playbook structure: plays target real inventory groups, reference roles
  that exist on disk, and every role task names exactly one known module;
- every jinja template/expression a task uses ({{ }}, when:, until:,
  changed_when:) must COMPILE under jinja2;
- `evaluate_expression` actually EXECUTES an expression under jinja2 with
  ansible's filter set emulated (trim/split/select/map/int/sum/bool...),
  so the load-bearing gkejoin readiness condition is tested against real
  sample outputs, not just eyeballed — `--syntax-check` would never catch
  a filter-chain bug there.

The port's copy of `tritonk8ssupervisor_tpu/infra/ansiblecheck.py`, whole
and under the reference's names; `validate_playbook` also takes the GPU
playbook (`clusterUpGpu.yml`).
"""

from __future__ import annotations

from pathlib import Path

import jinja2
import yaml

# the modules the roles are allowed to use; additions are deliberate
KNOWN_MODULES = {
    "ansible.builtin.command",
    "ansible.builtin.shell",
    "ansible.builtin.copy",
    "ansible.builtin.template",
    "ansible.builtin.file",
    "ansible.builtin.lineinfile",
    "ansible.builtin.pip",
    "ansible.builtin.slurp",
    "ansible.builtin.wait_for",
    "ansible.builtin.systemd",  # the maintenance watchdog unit
}

TASK_KEYWORDS = {
    "name", "register", "when", "until", "retries", "delay",
    "changed_when", "failed_when", "become", "vars", "environment",
    "delegate_to", "run_once",
}


class AnsibleCheckError(ValueError):
    pass


def _jinja_env() -> jinja2.Environment:
    env = jinja2.Environment()
    # ansible filters the roles use that plain jinja2 lacks
    env.filters["split"] = lambda s, sep=None: s.split(sep) if sep else s.split()
    env.filters["bool"] = lambda v: str(v).lower() in ("1", "true", "yes", "on")
    env.filters["trim"] = lambda s: s.strip()
    env.filters["b64decode"] = lambda s: __import__("base64").b64decode(s).decode()
    return env


def compile_expression(expr: str) -> None:
    """when:/until: style bare expression — compiled as {% if expr %}."""
    _jinja_env().parse("{% if " + expr + " %}x{% endif %}")


def compile_template(text: str) -> None:
    _jinja_env().parse(text)


def evaluate_expression(expr: str, variables: dict) -> bool:
    """Execute a when:/until: expression the way ansible would."""
    env = _jinja_env()
    template = env.from_string("{% if " + expr + " %}True{% else %}False{% endif %}")
    return template.render(**variables) == "True"


def validate_tasks(tasks: list, where: str) -> list[str]:
    problems = []
    if not isinstance(tasks, list):
        return [f"{where}: tasks file is not a list"]
    for task in tasks:
        if not isinstance(task, dict) or "name" not in task:
            problems.append(f"{where}: task without a name: {task!r}")
            continue
        label = f"{where}: {task['name']}"
        modules = [k for k in task if k not in TASK_KEYWORDS]
        if len(modules) != 1:
            problems.append(f"{label}: expected exactly one module, got {modules}")
        elif modules[0] not in KNOWN_MODULES:
            problems.append(f"{label}: unknown module {modules[0]}")
        for key in ("when", "until", "changed_when", "failed_when"):
            if key in task:
                conditions = task[key]
                for cond in conditions if isinstance(conditions, list) else [conditions]:
                    if isinstance(cond, bool):
                        continue
                    try:
                        compile_expression(str(cond))
                    except jinja2.TemplateError as e:
                        problems.append(f"{label}: {key} does not compile: {e}")
        try:
            compile_template(yaml.safe_dump(task))
        except jinja2.TemplateError as e:
            problems.append(f"{label}: template does not compile: {e}")
        if ("retries" in task) != ("until" in task):
            problems.append(f"{label}: retries and until must come together")
    return problems


def validate_playbook(ansible_dir: Path, inventory_groups: set[str],
                      playbook_name: str = "clusterUp.yml") -> list[str]:
    problems = []
    playbook = ansible_dir / playbook_name
    plays = yaml.safe_load(playbook.read_text())
    if not isinstance(plays, list) or not plays:
        return [f"{playbook}: not a list of plays"]
    for play in plays:
        hosts = play.get("hosts")
        if hosts not in inventory_groups:
            problems.append(f"play {play.get('name')}: unknown group {hosts}")
        for role in play.get("roles", []):
            role_dir = ansible_dir / "roles" / role
            tasks_file = role_dir / "tasks" / "main.yml"
            if not tasks_file.is_file():
                problems.append(f"role {role}: missing {tasks_file}")
                continue
            problems += validate_tasks(
                yaml.safe_load(tasks_file.read_text()), f"role {role}"
            )
            defaults_file = role_dir / "defaults" / "main.yml"
            if defaults_file.is_file():
                defaults = yaml.safe_load(defaults_file.read_text())
                if not isinstance(defaults, dict):
                    problems.append(f"role {role}: defaults not a mapping")
    return problems

"""Static validation of the infrastructure-as-code surface.

The reference had no way to test its generated HCL or playbooks short of
burning real VMs (SURVEY.md §4: no test suite of any kind). This package
gives the dev loop what `terraform validate` / `ansible-playbook
--syntax-check` would — without requiring the binaries, which CI images
may lack:

- hcl:          an HCL2 parser (lark) + semantic checks for the terraform
                modules: declared-vs-used variables, resolvable resource
                references, tfvars coverage, and a deterministic "plan"
                rendering for golden tests.
- ansiblecheck: playbook/role structural validation + compilation (and
                targeted evaluation) of the jinja expressions roles rely
                on, with ansible's filter set emulated.

When the real binaries are present, the skipif-gated subprocess tests in
tests/test_infra.py run too; these checks are the floor, not the ceiling.

The port's copy of `tritonk8ssupervisor_tpu/infra/`, whole: the port imports
nothing of the JAX package.
"""

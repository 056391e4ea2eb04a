"""Run-directory cleanup for the port's test files (``test_torch_*.py``).

A port CLI test at resnet18 width keeps three 89.5 MB msgpack files, and
pytest keeps the base temp dirs of its last three sessions, so the
suite's run dirs add up to gigabytes on a shared ``/tmp``. Each port test
file imports the two autouse fixtures below::

    from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

- ``remove_run_dir``: a test that asks for ``tmp_path`` has it removed
  once the test is over (its asserts done, passed or failed);
- ``remove_module_run_dirs``: whatever the module's tests and fixtures
  made under the session's base temp dir (``tmp_path_factory.mktemp``
  in module-scoped fixtures) is removed when the module ends.
"""

from __future__ import annotations

import os
import shutil

import pytest


@pytest.fixture(autouse=True)
def remove_run_dir(request):
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def remove_module_run_dirs(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(os.listdir(base))
    yield
    for name in set(os.listdir(base)) - before:
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)

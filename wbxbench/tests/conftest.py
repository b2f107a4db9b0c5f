"""Set-up shared by the harness's tests.

``test_wbxbench_kinds.make_root`` copies ``wbxbench/`` and then makes its
``generators/`` and ``references/`` folders for the tiny kind's modules.
A configuration that names its own modules (``hres_0p25``) brings both
folders, so the copy already holds them: there the kind's modules go in
beside the configuration's own.
"""

import pathlib

import pytest

_MODULE_FOLDERS = ('generators', 'references')


@pytest.fixture(autouse=True)
def _module_folders_may_exist(request, monkeypatch):
  if request.module.__name__.rsplit('.', 1)[-1] != 'test_wbxbench_kinds':
    return
  request.getfixturevalue('tmp_path')  # made before the patch, as pytest makes it
  mkdir = pathlib.Path.mkdir

  def beside_existing(self, *args, **kwargs):
    if (self.name in _MODULE_FOLDERS and self.parent.name == 'wbxbench'
        and self.is_dir()):
      return None
    return mkdir(self, *args, **kwargs)
  monkeypatch.setattr(pathlib.Path, 'mkdir', beside_existing)

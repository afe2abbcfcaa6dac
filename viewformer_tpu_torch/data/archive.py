"""Zip archives of the raw datasets (port of viewformer_tpu/data/archive.py).

ArchiveStore opens `<filename>.zip` (also a zip inside a zip, given as an
open file) and extracts a member when it is first opened: into the
directory of the archive, or into the temporary directory of the active
ArchiveStoreContext. Member names are listed without a common `<prefix>/./`
or a `<archive name>/` top directory. Tar archives raise.
"""
import fnmatch
import os
import shutil
import sys
import tempfile
import zipfile

from ..utils import unique


class ArchiveStoreContext:
    """A temporary directory that the ArchiveStores opened inside the
    context extract into; removed on exit."""

    _current_context = None

    def __init__(self):
        self._dir = None
        self.path = None

    def __enter__(self):
        self._old_context = ArchiveStoreContext._current_context
        ArchiveStoreContext._current_context = self
        self._dir = tempfile.TemporaryDirectory()
        self.path = self._dir.__enter__()
        return self

    def __exit__(self, *args):
        ArchiveStoreContext._current_context = self._old_context
        self._dir.__exit__(*args)
        self.path = None
        self._old_context = None

    @staticmethod
    def current_context():
        return ArchiveStoreContext._current_context


class ArchiveStore:
    """`file`: a path without its `.zip`, or an open zip file (a member of
    another archive)."""

    def __init__(self, file):
        if isinstance(file, str):
            self.filename = file
            self.file = None
        elif hasattr(file, 'read'):
            self.filename = file.name
            for suffix in ('.zip', '.tar.gz'):
                if self.filename.endswith(suffix):
                    self.filename = self.filename[:-len(suffix)]
            self.file = file
        self._path = None
        self._filelist = None
        self._archive = None
        self._archive_prefix = ''

    @staticmethod
    def with_context():
        return ArchiveStoreContext()

    def __enter__(self):
        if os.path.exists(f'{self.filename}.zip'):
            archive_name = os.path.split(self.filename)[1]
            try:
                self._archive = zipfile.ZipFile(f'{self.filename}.zip', 'r')
            except Exception:
                print(f'Invalid archive file "{self.filename}.zip"', file=sys.stderr)
                raise
            self._archive_prefix = ''
            filelist = [x.filename for x in self._archive.filelist]
            if filelist and all('/./' in x for x in filelist):
                strip = filelist[0][:filelist[0].find('/./') + 3]
                self._archive_prefix += strip
                filelist = [x[len(strip):] for x in filelist]
            if filelist and all(x.startswith(archive_name + '/') for x in filelist):
                self._archive_prefix += archive_name + '/'
                filelist = [x[len(archive_name) + 1:] for x in filelist]
            self._filelist = filelist
            ctx = ArchiveStoreContext.current_context()
            self._path = os.path.join(ctx.path, archive_name) if ctx is not None else self.filename
        elif os.path.exists(f'{self.filename}.tar.gz'):
            raise RuntimeError(
                f'Tar is not supported, please convert tar files to zip: {self.filename}')
        else:
            raise RuntimeError(f'File not found {self.filename}')
        return self

    def open(self, file, mode='r'):
        """The member `file`, extracted on first use, opened with `mode`."""
        target = os.path.join(self._path, file)
        if not os.path.exists(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            member = self._archive.getinfo(self._archive_prefix + file)
            with open(target, 'wb') as out, self._archive.open(member) as src:
                shutil.copyfileobj(src, out)
        return open(target, mode)

    def glob(self, pattern):
        """Members matching an fnmatch pattern (its `*` also matches `/`)."""
        return fnmatch.filter(self._filelist, pattern)

    def ls(self, path):
        """The entries directly under `path` ('' for the top)."""
        return [x.rstrip('/') for x in self._filelist
                if x.startswith(path) and '/' not in x[len(path):-1] and x != '']

    def __exit__(self, *args):
        self._filelist = None
        self._path = None
        self.close()

    def close(self):
        if self._archive is not None:
            self._archive.close()
            self._archive = None

    @staticmethod
    def list_archives(path):
        """The archive names in directory `path`, sorted, without `.zip` or
        `.tar.gz`."""
        files = os.listdir(path)
        files = unique(x[:-len('.zip')] if x.endswith('.zip')
                       else (x[:-len('.tar.gz')] if x.endswith('.tar.gz') else x)
                       for x in files)
        return sorted(files)

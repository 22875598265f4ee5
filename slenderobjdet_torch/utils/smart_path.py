"""Path factory dispatching local vs object-storage paths.

Counterpart of the reference's `concern/smart_path.py:1-5`, which bound the
`smart_path` package to an internal OSS endpoint. Here local paths (data on
an attached disk or NFS) resolve to `pathlib.Path`; `s3://` URIs are gated
behind an optional `s3path` import, so object storage works where that
package exists without making it a dependency. A copy of
``slenderobjdet_tpu/utils/smart_path.py``.
"""

from __future__ import annotations

import pathlib


def smart_path(path, endpoint_url: str = ""):
    s = str(path)
    if s.startswith("s3://"):
        try:
            from s3path import S3Path
        except ImportError as e:
            raise ImportError(
                "smart_path: s3:// paths need the optional 's3path' package "
                "(pip install s3path); local paths need no extras"
            ) from e
        return S3Path(s[len("s3:/"):])
    return pathlib.Path(s)

"""Run-completion notifications (optional, no-op without a backend): a copy
of ``mft_tpu/utils/notifications.py``.

Role parity with reference MFT/utils/telegram_notification.py:7-70: the
benchmark runner pings on finish/failure. Here the transport is pluggable —
a shell command template from the MFT_NOTIFY_CMD env var (e.g. a curl to any
webhook) or the optional telegram_send package; silently a no-op otherwise.
"""

import logging
import os
import shlex
import subprocess

logger = logging.getLogger(__name__)


def send_notification(message, use_markdown=False):
    cmd_tpl = os.environ.get("MFT_NOTIFY_CMD")
    if cmd_tpl:
        try:
            subprocess.run(cmd_tpl.replace("{message}", shlex.quote(message)),
                           shell=True, timeout=30, check=False)
            return True
        except Exception:
            logger.exception("notification command failed")
            return False
    try:
        import telegram_send
        telegram_send.send(messages=[message], parse_mode="markdown" if use_markdown else None)
        return True
    except ImportError:
        logger.debug("no notification backend configured; message: %s", message)
        return False
    except Exception:
        logger.exception("telegram notification failed")
        return False


def with_notification(fn):
    """Decorator: notify on completion/failure (reference with_telegram)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            result = fn(*args, **kwargs)
            send_notification(f"{fn.__name__} finished")
            return result
        except Exception as e:
            send_notification(f"{fn.__name__} FAILED: {e!r}")
            raise

    return wrapper

"""The port's native host library: its own copies of the reference's C++
host ops (interner, pre-pool, grid pack, compact decode), order codec and
file log, built with g++ at first use (`build.load`). Bound by
``engine/nativehost.py`` and ``bus/native.py``; nothing here runs at
import."""

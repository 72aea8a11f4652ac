/* thpalloc — a transparent-hugepage numpy data allocator (the port's copy
 * of the JAX package's native/src/thpalloc.c, built by
 * utils/nphost._install_thpalloc into build/torch_native/).
 *
 * Role: the host planners (ops/ell_plan.plan_ell and friends) are
 * nnz-scale numpy passes, and on a virtualised host the first touch of a
 * fresh 4 KB page can cost ~160 us (the JAX package measured this on its
 * TPU host, where it made up nearly all of a 9.8 s cant-class plan).  A
 * 2 MB transparent huge page faults once for 512 such pages, so serving
 * large numpy buffers from MADV_HUGEPAGE mappings removes most of that
 * cost at the source.
 *
 * Design: installed with PyDataMem_SetHandler, so only numpy array
 * buffers route here.  Allocations >= 1 MB get a shared anonymous mmap
 * rounded and aligned to 2 MB (no free lists; calloc is free because
 * fresh maps are zero-filled); smaller ones go to malloc.  Every block
 * carries a 64-byte header (magic, usable size, map length, kind), so
 * free and realloc never guess the owner.  Shared rather than private
 * anonymous memory: on the host where this was measured, first touches
 * of private anonymous pages took a copy-on-write slow path that shared
 * pages did not.  The difference shows only across fork(), where a child
 * would share writes to these buffers; the port does not fork with live
 * numpy buffers.
 */

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define THP_SIZE ((size_t)2 << 20)
#define BIG_THRESHOLD ((size_t)1 << 20)
#define HDR_SIZE 64
#define MAGIC 0x7A68506147654D55ULL /* arbitrary tag */

#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

typedef struct {
  uint64_t magic;
  uint64_t usable;   /* bytes usable at the returned pointer */
  uint64_t map_len;  /* full mmap length (mmap blocks only) */
  uint64_t kind;     /* 0 = malloc, 1 = mmap */
  char pad[HDR_SIZE - 32];
} blk_hdr;

static size_t thp_bytes_live = 0;
static size_t thp_blocks_live = 0;

/* A tiny cache of freed mappings: reusing a warm mapping skips both the
 * munmap/mmap pair and the shmem re-fault.  Exact-length match only;
 * capped so idle buffers cannot pin more than CACHE_CAP bytes. */
#define CACHE_SLOTS 16
#define CACHE_CAP ((size_t)768 << 20)
static struct {
  void *base;
  size_t len;
} blk_cache[CACHE_SLOTS];
static size_t cache_bytes = 0;
static pthread_mutex_t thp_lock = PTHREAD_MUTEX_INITIALIZER;

static void *cache_take(size_t len) {
  pthread_mutex_lock(&thp_lock);
  for (int i = 0; i < CACHE_SLOTS; i++) {
    if (blk_cache[i].base && blk_cache[i].len == len) {
      void *p = blk_cache[i].base;
      blk_cache[i].base = NULL;
      cache_bytes -= len;
      pthread_mutex_unlock(&thp_lock);
      return p;
    }
  }
  pthread_mutex_unlock(&thp_lock);
  return NULL;
}

static int cache_put(void *base, size_t len) {
  pthread_mutex_lock(&thp_lock);
  if (cache_bytes + len > CACHE_CAP) {
    pthread_mutex_unlock(&thp_lock);
    return 0;
  }
  for (int i = 0; i < CACHE_SLOTS; i++) {
    if (!blk_cache[i].base) {
      blk_cache[i].base = base;
      blk_cache[i].len = len;
      cache_bytes += len;
      pthread_mutex_unlock(&thp_lock);
      return 1;
    }
  }
  pthread_mutex_unlock(&thp_lock);
  return 0;
}

static void *big_alloc(size_t usable, int zero) {
  size_t len = (usable + HDR_SIZE + THP_SIZE - 1) & ~(THP_SIZE - 1);
  char *cached = (char *)cache_take(len);
  if (cached) {
    if (zero) memset(cached + HDR_SIZE, 0, usable); /* cached maps are dirty */
    blk_hdr *h = (blk_hdr *)cached;
    h->magic = MAGIC;
    h->usable = usable;
    h->map_len = len;
    h->kind = 1;
    __atomic_add_fetch(&thp_bytes_live, len, __ATOMIC_RELAXED);
    __atomic_add_fetch(&thp_blocks_live, 1, __ATOMIC_RELAXED);
    return cached + HDR_SIZE;
  }
  /* overmap by one THP so the block can be trimmed to 2 MB alignment */
  size_t over = len + THP_SIZE;
  char *raw = (char *)mmap(NULL, over, PROT_READ | PROT_WRITE,
                           MAP_SHARED | MAP_ANONYMOUS, -1, 0);
  if (raw == MAP_FAILED) return NULL;
  char *base = (char *)(((uintptr_t)raw + THP_SIZE - 1) & ~(THP_SIZE - 1));
  size_t lead = (size_t)(base - raw);
  if (lead) munmap(raw, lead);
  size_t tail = over - lead - len;
  if (tail) munmap(base + len, tail);
  madvise(base, len, MADV_HUGEPAGE); /* honored only if shmem THP enabled */
  blk_hdr *h = (blk_hdr *)base;
  h->magic = MAGIC;
  h->usable = usable;
  h->map_len = len;
  h->kind = 1;
  __atomic_add_fetch(&thp_bytes_live, len, __ATOMIC_RELAXED);
  __atomic_add_fetch(&thp_blocks_live, 1, __ATOMIC_RELAXED);
  return base + HDR_SIZE;
}

static void *small_alloc(size_t usable, int zero) {
  char *base = zero ? (char *)calloc(1, usable + HDR_SIZE)
                    : (char *)malloc(usable + HDR_SIZE);
  if (!base) return NULL;
  blk_hdr *h = (blk_hdr *)base;
  h->magic = MAGIC;
  h->usable = usable;
  h->map_len = 0;
  h->kind = 0;
  return base + HDR_SIZE;
}

static void *thp_malloc(void *ctx, size_t size) {
  (void)ctx;
  if (size == 0) size = 1;
  return size >= BIG_THRESHOLD ? big_alloc(size, 0) : small_alloc(size, 0);
}

static void *thp_calloc(void *ctx, size_t nelem, size_t elsize) {
  (void)ctx;
  if (nelem && elsize > (size_t)-1 / nelem) return NULL;
  size_t size = nelem * elsize;
  if (size == 0) size = 1;
  /* fresh maps are zero-filled; cached ones are memset inside */
  return size >= BIG_THRESHOLD ? big_alloc(size, 1) : small_alloc(size, 1);
}

static void thp_free(void *ctx, void *ptr, size_t size) {
  (void)ctx;
  (void)size;
  if (!ptr) return;
  blk_hdr *h = (blk_hdr *)((char *)ptr - HDR_SIZE);
  if (h->magic != MAGIC) return; /* never ours — refuse to guess */
  if (h->kind == 1) {
    __atomic_sub_fetch(&thp_bytes_live, h->map_len, __ATOMIC_RELAXED);
    __atomic_sub_fetch(&thp_blocks_live, 1, __ATOMIC_RELAXED);
    if (!cache_put(h, h->map_len)) munmap((char *)h, h->map_len);
  } else {
    free(h);
  }
}

static void *thp_realloc(void *ctx, void *ptr, size_t new_size) {
  if (!ptr) return thp_malloc(ctx, new_size);
  blk_hdr *h = (blk_hdr *)((char *)ptr - HDR_SIZE);
  if (h->magic != MAGIC) return NULL;
  if (new_size == 0) new_size = 1;
  size_t old = h->usable;
  if (h->kind == 0 && new_size < BIG_THRESHOLD) {
    /* small->small: let malloc move the block (header travels along) */
    blk_hdr *nh = (blk_hdr *)realloc(h, new_size + HDR_SIZE);
    if (!nh) return NULL;
    nh->usable = new_size;
    return (char *)nh + HDR_SIZE;
  }
  if (h->kind == 1 && new_size >= BIG_THRESHOLD && new_size + HDR_SIZE <= h->map_len) {
    h->usable = new_size; /* shrink or grow within the mapped round-up */
    return ptr;
  }
  void *fresh = thp_malloc(ctx, new_size);
  if (!fresh) return NULL;
  memcpy(fresh, ptr, old < new_size ? old : new_size);
  thp_free(ctx, ptr, old);
  return fresh;
}

static PyDataMem_Handler thp_handler = {
    "thpalloc",
    1,
    {
        NULL,
        thp_malloc,
        thp_calloc,
        thp_realloc,
        thp_free,
    },
};

static PyObject *py_install(PyObject *self, PyObject *args) {
  (void)self;
  (void)args;
  PyObject *capsule =
      PyCapsule_New(&thp_handler, "mem_handler", NULL);
  if (!capsule) return NULL;
  PyObject *old = PyDataMem_SetHandler(capsule);
  Py_DECREF(capsule);
  if (!old) return NULL;
  Py_DECREF(old);
  Py_RETURN_TRUE;
}

static PyObject *py_stats(PyObject *self, PyObject *args) {
  (void)self;
  (void)args;
  return Py_BuildValue("(KK)", (unsigned long long)thp_blocks_live,
                       (unsigned long long)thp_bytes_live);
}

static PyMethodDef methods[] = {
    {"install", py_install, METH_NOARGS,
     "Install the THP allocator as numpy's data handler (new arrays only)."},
    {"stats", py_stats, METH_NOARGS,
     "(live_blocks, live_mapped_bytes) currently served by the THP path."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_thpalloc",
    "Transparent-hugepage numpy data allocator (see src/thpalloc.c).",
    -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__thpalloc(void) {
  import_array();
  return PyModule_Create(&moduledef);
}

/* A fake NVML for the hermetic tests of tpumon_torch.backends.nvml.
 *
 * Built by the tests with the host's cc into a shared library and loaded
 * through TPUMON_NVML_PATH, so the backend's real dlopen, symbol
 * resolution and ctypes layouts are what run.  Device i serves fixed
 * values (below) that the tests convert by the catalog's unit rules.
 *
 *   cc -shared -fPIC -I tpumon_torch/testlib -o libfake_nvml.so \
 *      tpumon_torch/testlib/fake_nvml.c -lpthread [-DOMIT_ECC ...]
 *
 * -DOMIT_ECC, -DOMIT_FIELD_VALUES and -DOMIT_EVENTS leave those entry
 * points out (a driver without them).  The fake_nvml_* functions are the
 * tests' controls: a return code forced on an entry point by name (or on
 * one field value, as "field:<id>"), the device count, an Xid queued for
 * the event set, a step of the NVLink data counters and their clock, and
 * the counts of nvmlInit_v2 and nvmlShutdown calls.  FAKE_NVML_XIDS
 * ("dev:xid,dev:xid,...") queues Xids through fake_nvml_inject_xid at
 * nvmlInit_v2: the hook of a test whose NVML runs in another process (an
 * agent). */
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "nvml.h"

#define MAX_DEVICES 8
#define MAX_OVERRIDES 16
#define LINKS 4
#define MIB (1024ULL * 1024ULL)

struct nvmlDevice_st { int index; };
struct nvmlEventSet_st { int unused; };

static struct nvmlDevice_st g_devs[MAX_DEVICES];
static struct nvmlEventSet_st g_set;
static int g_count = 2;
static struct { char name[64]; int rc; } g_over[MAX_OVERRIDES];
static int g_nover;
static long long g_clock_us = 1000000;
static unsigned long long g_link_kib[MAX_DEVICES][LINKS][2];

static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t g_cv = PTHREAD_COND_INITIALIZER;
static struct { int dev; unsigned long long xid; } g_xids[32];
static int g_nxid;
static int g_inits;
static int g_shutdowns;

/* ---- controls ----------------------------------------------------------- */

void fake_nvml_reset(void) {
  pthread_mutex_lock(&g_mu);
  g_count = 2;
  g_nover = 0;
  g_nxid = 0;
  g_clock_us = 1000000;
  g_inits = 0;
  g_shutdowns = 0;
  memset(g_link_kib, 0, sizeof(g_link_kib));
  pthread_mutex_unlock(&g_mu);
}

int fake_nvml_inits(void) { return g_inits; }

int fake_nvml_shutdowns(void) { return g_shutdowns; }

void fake_nvml_set_count(int n) { g_count = n; }

void fake_nvml_set_rc(const char *fn, int rc) {
  if (g_nover < MAX_OVERRIDES) {
    snprintf(g_over[g_nover].name, sizeof(g_over[g_nover].name), "%s", fn);
    g_over[g_nover++].rc = rc;
  }
}

void fake_nvml_inject_xid(int dev, unsigned long long xid) {
  pthread_mutex_lock(&g_mu);
  if (g_nxid < 32) {
    g_xids[g_nxid].dev = dev;
    g_xids[g_nxid++].xid = xid;
  }
  pthread_cond_broadcast(&g_cv);
  pthread_mutex_unlock(&g_mu);
}

/* every link's TX counter grows by kib * (link + 1), RX by twice that */
void fake_nvml_advance(long long us, unsigned long long kib) {
  g_clock_us += us;
  for (int d = 0; d < MAX_DEVICES; d++)
    for (int l = 0; l < LINKS; l++) {
      g_link_kib[d][l][0] += kib * (unsigned long long)(l + 1);
      g_link_kib[d][l][1] += 2 * kib * (unsigned long long)(l + 1);
    }
}

static int forced(const char *fn) {
  for (int i = 0; i < g_nover; i++)
    if (strcmp(g_over[i].name, fn) == 0) return g_over[i].rc;
  return NVML_SUCCESS;
}

#define FORCED(fn)              \
  do {                          \
    int rc_ = forced(fn);       \
    if (rc_) return rc_;        \
  } while (0)

static int dev_index(nvmlDevice_t d) {
  if (!d || d < g_devs || d >= g_devs + g_count) return -1;
  return d->index;
}

#define DEVICE(fn, d, i)                          \
  FORCED(fn);                                     \
  int i = dev_index(d);                           \
  if (i < 0) return NVML_ERROR_INVALID_ARGUMENT

static nvmlReturn_t copy_str(char *out, unsigned int len, const char *s) {
  if (strlen(s) + 1 > len) return NVML_ERROR_INVALID_ARGUMENT;
  snprintf(out, len, "%s", s);
  return NVML_SUCCESS;
}

/* ---- init and inventory ------------------------------------------------- */

nvmlReturn_t nvmlInit_v2(void) {
  FORCED("nvmlInit_v2");
  for (int i = 0; i < MAX_DEVICES; i++) g_devs[i].index = i;
  g_inits++;
  const char *xids = getenv("FAKE_NVML_XIDS");
  while (xids && *xids) {
    char *end;
    int dev = (int)strtol(xids, &end, 10);
    if (*end != ':') break;
    unsigned long long xid = strtoull(end + 1, &end, 10);
    fake_nvml_inject_xid(dev, xid);
    xids = *end == ',' ? end + 1 : end;
  }
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlInitWithFlags(unsigned int flags) {
  (void)flags;
  return nvmlInit_v2();
}

nvmlReturn_t nvmlShutdown(void) {
  g_shutdowns++;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetCount_v2(unsigned int *n) {
  FORCED("nvmlDeviceGetCount_v2");
  *n = (unsigned int)g_count;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetHandleByIndex_v2(unsigned int i, nvmlDevice_t *d) {
  if ((int)i >= g_count) return NVML_ERROR_INVALID_ARGUMENT;
  *d = &g_devs[i];
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlSystemGetDriverVersion(char *v, unsigned int len) {
  FORCED("nvmlSystemGetDriverVersion");
  return copy_str(v, len, "550.54.15");
}

nvmlReturn_t nvmlDeviceGetName(nvmlDevice_t d, char *s, unsigned int len) {
  DEVICE("nvmlDeviceGetName", d, i);
  (void)i;
  return copy_str(s, len, "NVIDIA H100 80GB HBM3");
}

nvmlReturn_t nvmlDeviceGetUUID(nvmlDevice_t d, char *s, unsigned int len) {
  DEVICE("nvmlDeviceGetUUID", d, i);
  char buf[64];
  snprintf(buf, sizeof(buf), "GPU-00000000-1111-2222-3333-%012d", i);
  return copy_str(s, len, buf);
}

nvmlReturn_t nvmlDeviceGetSerial(nvmlDevice_t d, char *s, unsigned int len) {
  DEVICE("nvmlDeviceGetSerial", d, i);
  char buf[32];
  snprintf(buf, sizeof(buf), "165000000%d", i);
  return copy_str(s, len, buf);
}

nvmlReturn_t nvmlDeviceGetVbiosVersion(nvmlDevice_t d, char *s,
                                       unsigned int len) {
  DEVICE("nvmlDeviceGetVbiosVersion", d, i);
  char buf[32];
  snprintf(buf, sizeof(buf), "96.00.74.00.%02d", i);
  return copy_str(s, len, buf);
}

nvmlReturn_t nvmlDeviceGetMinorNumber(nvmlDevice_t d, unsigned int *m) {
  DEVICE("nvmlDeviceGetMinorNumber", d, i);
  *m = (unsigned int)i;
  return NVML_SUCCESS;
}

static void fill_pci(int i, nvmlPciInfo_t *p) {
  memset(p, 0, sizeof(*p));
  p->domain = 0;
  p->bus = 0x18 + 0x10 * (unsigned int)i;
  p->pciDeviceId = 0x233010de;
  snprintf(p->busId, sizeof(p->busId), "00000000:%02X:00.0", p->bus);
  snprintf(p->busIdLegacy, sizeof(p->busIdLegacy), "0000:%02X:00.0", p->bus);
}

nvmlReturn_t nvmlDeviceGetPciInfo_v3(nvmlDevice_t d, nvmlPciInfo_t *p) {
  DEVICE("nvmlDeviceGetPciInfo_v3", d, i);
  fill_pci(i, p);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetMaxClockInfo(nvmlDevice_t d, nvmlClockType_t t,
                                       unsigned int *mhz) {
  DEVICE("nvmlDeviceGetMaxClockInfo", d, i);
  (void)i;
  *mhz = t == NVML_CLOCK_SM ? 1980 : t == NVML_CLOCK_MEM ? 2619 : 0;
  return *mhz ? NVML_SUCCESS : NVML_ERROR_NOT_SUPPORTED;
}

nvmlReturn_t nvmlDeviceGetClockInfo(nvmlDevice_t d, nvmlClockType_t t,
                                    unsigned int *mhz) {
  DEVICE("nvmlDeviceGetClockInfo", d, i);
  *mhz = t == NVML_CLOCK_SM ? 1755 + (unsigned int)i
                            : t == NVML_CLOCK_MEM ? 2619 : 0;
  return *mhz ? NVML_SUCCESS : NVML_ERROR_NOT_SUPPORTED;
}

nvmlReturn_t nvmlDeviceGetEnforcedPowerLimit(nvmlDevice_t d,
                                             unsigned int *mw) {
  DEVICE("nvmlDeviceGetEnforcedPowerLimit", d, i);
  (void)i;
  *mw = 700000;
  return NVML_SUCCESS;
}

/* ---- dynamic reads ------------------------------------------------------ */

nvmlReturn_t nvmlDeviceGetPowerUsage(nvmlDevice_t d, unsigned int *mw) {
  DEVICE("nvmlDeviceGetPowerUsage", d, i);
  *mw = 123456 + 1000 * (unsigned int)i;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetTotalEnergyConsumption(nvmlDevice_t d,
                                                 unsigned long long *mj) {
  DEVICE("nvmlDeviceGetTotalEnergyConsumption", d, i);
  *mj = 987654321ULL + (unsigned long long)i;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t d, nvmlMemory_v2_t *m) {
  DEVICE("nvmlDeviceGetMemoryInfo_v2", d, i);
  (void)i;
  if (m->version != nvmlMemory_v2) return NVML_ERROR_ARGUMENT_VERSION_MISMATCH;
  m->total = 81559ULL * MIB;
  m->reserved = 512ULL * MIB;
  m->used = 1234ULL * MIB + 5;
  m->free = m->total - m->reserved - m->used;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetTemperature(nvmlDevice_t d,
                                      nvmlTemperatureSensors_t s,
                                      unsigned int *c) {
  DEVICE("nvmlDeviceGetTemperature", d, i);
  if (s != NVML_TEMPERATURE_GPU) return NVML_ERROR_NOT_SUPPORTED;
  *c = 41 + (unsigned int)i;
  return NVML_SUCCESS;
}

#ifndef OMIT_FIELD_VALUES
nvmlReturn_t nvmlDeviceGetNvLinkState(nvmlDevice_t d, unsigned int link,
                                      nvmlEnableState_t *s);

nvmlReturn_t nvmlDeviceGetFieldValues(nvmlDevice_t d, int n,
                                      nvmlFieldValue_t *v) {
  DEVICE("nvmlDeviceGetFieldValues", d, i);
  for (int k = 0; k < n; k++) {
    nvmlFieldValue_t *f = &v[k];
    f->timestamp = g_clock_us;
    f->latencyUsec = 0;
    f->nvmlReturn = NVML_SUCCESS;
    unsigned int link = f->scopeId;
    char name[32];
    snprintf(name, sizeof(name), "field:%u", f->fieldId);
    if ((f->nvmlReturn = forced(name))) continue;
    if (f->fieldId == NVML_FI_DEV_MEMORY_TEMP) {
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_INT;
      f->value.uiVal = 52 + (unsigned int)i;
    } else if (f->fieldId >= NVML_FI_DEV_PERF_POLICY_POWER &&
               f->fieldId <= NVML_FI_DEV_PERF_POLICY_RELIABILITY) {
      /* policy p: (p + 1) ms and 123 ns of throttling */
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_LONG_LONG;
      f->value.ullVal = (f->fieldId - NVML_FI_DEV_PERF_POLICY_POWER + 1ULL) *
                        1000000ULL + 123ULL;
    } else if (f->fieldId == NVML_FI_DEV_TOTAL_ENERGY_CONSUMPTION) {
      /* the energy counter's own source, and its own refusals */
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_LONG_LONG;
      f->nvmlReturn = nvmlDeviceGetTotalEnergyConsumption(d, &f->value.ullVal);
    } else if (f->fieldId == NVML_FI_DEV_POWER_INSTANT) {
      /* mW, apart from nvmlDeviceGetPowerUsage's so a test can tell
         which reading served power */
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_INT;
      f->value.uiVal = 150250 + 1000 * (unsigned int)i;
    } else if (f->fieldId == NVML_FI_DEV_NVLINK_GET_STATE) {
      /* the link state entry point's source, and its own refusals */
      nvmlEnableState_t s;
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_INT;
      f->nvmlReturn = nvmlDeviceGetNvLinkState(d, link, &s);
      f->value.uiVal = (unsigned int)s;
    } else if ((f->fieldId == NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX ||
                f->fieldId == NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX) &&
               link < LINKS) {
      f->valueType = NVML_VALUE_TYPE_UNSIGNED_LONG_LONG;
      f->value.ullVal = g_link_kib[i][link][
          f->fieldId == NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX];
    } else {
      f->nvmlReturn = NVML_ERROR_NOT_SUPPORTED;
    }
  }
  return NVML_SUCCESS;
}
#endif

nvmlReturn_t nvmlDeviceGetPcieThroughput(nvmlDevice_t d,
                                         nvmlPcieUtilCounter_t c,
                                         unsigned int *kbs) {
  DEVICE("nvmlDeviceGetPcieThroughput", d, i);
  (void)i;
  *kbs = c == NVML_PCIE_UTIL_TX_BYTES ? 1500 : 2500;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetPcieReplayCounter(nvmlDevice_t d,
                                            unsigned int *n) {
  DEVICE("nvmlDeviceGetPcieReplayCounter", d, i);
  (void)i;
  *n = 7;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetUtilizationRates(nvmlDevice_t d,
                                           nvmlUtilization_t *u) {
  DEVICE("nvmlDeviceGetUtilizationRates", d, i);
  (void)i;
  u->gpu = 87;
  u->memory = 45;
  return NVML_SUCCESS;
}

#ifndef OMIT_ECC
nvmlReturn_t nvmlDeviceGetTotalEccErrors(nvmlDevice_t d,
                                         nvmlMemoryErrorType_t e,
                                         nvmlEccCounterType_t c,
                                         unsigned long long *n) {
  DEVICE("nvmlDeviceGetTotalEccErrors", d, i);
  (void)i;
  static const unsigned long long counts[2][2] = {{3, 11}, {1, 2}};
  *n = counts[e][c];
  return NVML_SUCCESS;
}
#endif

nvmlReturn_t nvmlDeviceGetRemappedRows(nvmlDevice_t d, unsigned int *corr,
                                       unsigned int *unc,
                                       unsigned int *pending,
                                       unsigned int *failed) {
  DEVICE("nvmlDeviceGetRemappedRows", d, i);
  (void)i;
  *corr = 4;
  *unc = 1;
  *pending = 0;
  *failed = 0;
  return NVML_SUCCESS;
}

/* ---- NVLink: four links, 0 and 1 up; device 0 link 0 <-> device 1 ------ */

nvmlReturn_t nvmlDeviceGetNvLinkState(nvmlDevice_t d, unsigned int link,
                                      nvmlEnableState_t *s) {
  DEVICE("nvmlDeviceGetNvLinkState", d, i);
  (void)i;
  if (link >= LINKS) return NVML_ERROR_NOT_SUPPORTED;
  *s = link < 2 ? NVML_FEATURE_ENABLED : NVML_FEATURE_DISABLED;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetNvLinkErrorCounter(nvmlDevice_t d,
                                             unsigned int link,
                                             nvmlNvLinkErrorCounter_t c,
                                             unsigned long long *n) {
  DEVICE("nvmlDeviceGetNvLinkErrorCounter", d, i);
  (void)i;
  if (link >= LINKS) return NVML_ERROR_NOT_SUPPORTED;
  *n = c == NVML_NVLINK_ERROR_DL_CRC_FLIT ? 10ULL * link + 1
       : c == NVML_NVLINK_ERROR_DL_RECOVERY ? link : 2ULL * link;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetNvLinkRemotePciInfo_v2(nvmlDevice_t d,
                                                 unsigned int link,
                                                 nvmlPciInfo_t *p) {
  DEVICE("nvmlDeviceGetNvLinkRemotePciInfo_v2", d, i);
  if (link != 0 || i > 1 || g_count < 2) return NVML_ERROR_NOT_SUPPORTED;
  fill_pci(1 - i, p);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetNvLinkRemoteDeviceType(
    nvmlDevice_t d, unsigned int link, nvmlIntNvLinkDeviceType_t *t) {
  DEVICE("nvmlDeviceGetNvLinkRemoteDeviceType", d, i);
  (void)i;
  if (link >= LINKS) return NVML_ERROR_NOT_SUPPORTED;
  *t = NVML_NVLINK_DEVICE_TYPE_GPU;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetCpuAffinity(nvmlDevice_t d, unsigned int n,
                                      unsigned long *set) {
  DEVICE("nvmlDeviceGetCpuAffinity", d, i);
  memset(set, 0, n * sizeof(*set));
  if (n) set[0] = 0xFUL << (4 * i);
  return NVML_SUCCESS;
}

/* ---- events ------------------------------------------------------------- */

#ifndef OMIT_EVENTS
nvmlReturn_t nvmlEventSetCreate(nvmlEventSet_t *s) {
  FORCED("nvmlEventSetCreate");
  *s = &g_set;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceRegisterEvents(nvmlDevice_t d,
                                      unsigned long long types,
                                      nvmlEventSet_t s) {
  DEVICE("nvmlDeviceRegisterEvents", d, i);
  (void)i;
  (void)types;
  return s == &g_set ? NVML_SUCCESS : NVML_ERROR_INVALID_ARGUMENT;
}

nvmlReturn_t nvmlEventSetWait_v2(nvmlEventSet_t s, nvmlEventData_t *e,
                                 unsigned int ms) {
  if (s != &g_set) return NVML_ERROR_INVALID_ARGUMENT;
  struct timespec until;
  clock_gettime(CLOCK_REALTIME, &until);
  until.tv_sec += ms / 1000;
  until.tv_nsec += (long)(ms % 1000) * 1000000L;
  if (until.tv_nsec >= 1000000000L) {
    until.tv_sec++;
    until.tv_nsec -= 1000000000L;
  }
  pthread_mutex_lock(&g_mu);
  while (g_nxid == 0) {
    if (pthread_cond_timedwait(&g_cv, &g_mu, &until)) {
      pthread_mutex_unlock(&g_mu);
      return NVML_ERROR_TIMEOUT;
    }
  }
  memset(e, 0, sizeof(*e));
  e->device = &g_devs[g_xids[0].dev];
  e->eventType = nvmlEventTypeXidCriticalError;
  e->eventData = g_xids[0].xid;
  memmove(g_xids, g_xids + 1, (size_t)--g_nxid * sizeof(g_xids[0]));
  pthread_mutex_unlock(&g_mu);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlEventSetFree(nvmlEventSet_t s) {
  return s == &g_set ? NVML_SUCCESS : NVML_ERROR_INVALID_ARGUMENT;
}
#endif

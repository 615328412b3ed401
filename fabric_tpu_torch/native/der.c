/* Batched strict-DER parsing of ECDSA signatures, in plain C.
 *
 * Counterpart of der_int32 and py_parse_der_sigs in
 * fabric_tpu/native/fastcollect.c, without the CPython API: the caller
 * joins the signatures into one buffer and passes N + 1 offsets, and the
 * Python wrapper (fabric_tpu_torch/native/__init__.py:parse_der_sigs)
 * rejects entries that are not bytes before joining, as the reference
 * does when PyBytes_AsStringAndSize fails.
 *
 * Semantics are the reference's: a SEQUENCE with a short-form length
 * covering the rest of the signature, holding exactly two INTEGERs in
 * strict DER (short-form lengths, minimal encodings, non-negative), each
 * in (0, 2^256).  A signature that fails any rule gets ok = 0 and an
 * all-zero rs row; one that passes gets ok = 1 and r32be || s32be.
 */

#include <stdint.h>
#include <string.h>

/* one strict-DER unsigned INTEGER in (0, 2^256) -> 32 bytes big-endian */
static int der_int32(const uint8_t **pp, const uint8_t *end, uint8_t out[32])
{
    const uint8_t *p = *pp;
    if (end - p < 2 || p[0] != 0x02) return -1;
    uint32_t l = p[1];
    /* values < 2^256 encode in <= 33 bytes < 128: short form only */
    if (l == 0 || l > 33 || (uint32_t)(end - p - 2) < l) return -1;
    p += 2;
    if (p[0] & 0x80) return -1;                 /* negative: out of range */
    if (l > 1 && p[0] == 0 && !(p[1] & 0x80)) return -1;   /* non-minimal */
    if (l == 33 && p[0] != 0) return -1;        /* >= 2^256 */
    const uint8_t *v = p;
    uint32_t vn = l;
    if (l == 33) { v++; vn = 32; }
    int zero = 1;
    for (uint32_t i = 0; i < vn; i++)
        if (v[i]) { zero = 0; break; }
    if (zero) return -1;                        /* r/s must be nonzero */
    memset(out, 0, 32 - vn);
    memcpy(out + (32 - vn), v, vn);
    *pp = p + l;
    return 0;
}

/* one signature [p, end) -> row = r32be || s32be; 0 when well-formed */
static int der_sig(const uint8_t *p, const uint8_t *end, uint8_t row[64])
{
    const int64_t sn = end - p;
    /* SEQUENCE header, short-form length covering the whole rest */
    if (sn < 8 || p[0] != 0x30 || p[1] >= 0x80 || (int64_t)p[1] != sn - 2)
        return -1;
    p += 2;
    if (der_int32(&p, end, row) < 0) return -1;
    if (der_int32(&p, end, row + 32) < 0) return -1;
    return p == end ? 0 : -1;                   /* trailing bytes */
}

/* buf[offs[i] .. offs[i+1]) is signature i.  Writes ok[n] and rs[64 n].
 * Returns 0, or -1 when the offsets are not non-decreasing from 0. */
int parse_der_sigs(const uint8_t *buf, const int64_t *offs, int64_t n,
                   uint8_t *ok, uint8_t *rs)
{
    if (n > 0 && offs[0] != 0) return -1;
    for (int64_t i = 0; i < n; i++) {
        if (offs[i + 1] < offs[i]) return -1;
    }
    for (int64_t i = 0; i < n; i++) {
        uint8_t *row = rs + 64 * i;
        ok[i] = der_sig(buf + offs[i], buf + offs[i + 1], row) == 0;
        if (!ok[i]) memset(row, 0, 64);
    }
    return 0;
}
